"""flo_torch's HTTP service against flo_tpu's, on the CPU.

The cases of ``tests/test_service.py`` against one module-scoped server of
the port (``make_server(..., device="cpu")``). A response that carries audio
is compared with ``flo_tpu.service._handle`` on the same request: lossless
DATA chunks and samples equal, lossy decodes of the same bytes within one
i16 step (``rint(x * 32767)``), a lossy encode's size within 1%. Metadata
is compared with the encoder stamps and the fingerprint hash left out (the
reference's multi-threaded BLAKE3 is not deterministic: ROADMAP.md section
3). Error cases give the same status codes as the reference.
"""

import json
import struct
import threading
import urllib.error
import urllib.request
from urllib.parse import parse_qs, urlparse

import numpy as np
import pytest
import torch

import flo_torch
from flo_torch import audio_io, reflo, service
from flo_torch.container import reader
from flo_tpu import service as tpu_service

STEP = np.float32(1.0 / 32767.0)


@pytest.fixture(scope="module")
def server_url():
    srv = service.make_server("127.0.0.1", 0, device="cpu")
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    yield f"http://127.0.0.1:{srv.server_address[1]}"
    srv.shutdown()
    t.join(timeout=10)
    srv.server_close()


def _post(url, path, body=b"", headers=None):
    req = urllib.request.Request(url + path, data=body, method="POST")
    for k, v in (headers or {}).items():
        req.add_header(k, v)
    with urllib.request.urlopen(req, timeout=60) as r:
        return r.status, dict(r.headers), r.read()


def _get(url, path):
    with urllib.request.urlopen(url + path, timeout=60) as r:
        return r.status, r.read()


def _status(fn, *args):
    """The HTTP status of a request expected to fail."""
    with pytest.raises(urllib.error.HTTPError) as e:
        fn(*args)
    return e.value.code


def _ref(path, body=b""):
    """flo_tpu.service._handle on the same request -> (status, payload, headers)."""
    u = urlparse(path)
    status, _, payload, extra = tpu_service._handle(u.path, parse_qs(u.query), body)
    return status, payload, extra


def _ref_status(path, body=b""):
    with pytest.raises(tpu_service.ServiceError) as e:
        _ref(path, body)
    return e.value.status


def sine(freq, rate, secs, channels=1):
    t = np.arange(int(rate * secs)) / rate
    s = (0.4 * np.sin(2 * np.pi * freq * t)).astype(np.float32)
    if channels == 2:
        s = np.stack([s, s], 1).reshape(-1)
    return s


def encode(s, rate, channels=1, analyze=False):
    return flo_torch.encode(s, rate, channels, analyze=analyze, device="cpu")


def _data_chunk(data):
    h = reader.read(data).header
    lo = 4 + h.header_size + h.toc_size
    return data[lo : lo + h.data_size]


def _i16(raw):
    return np.rint(np.frombuffer(raw, "<f4") / STEP)


def _within_one_step(a, b):
    a, b = _i16(a), _i16(b)
    assert a.shape == b.shape and np.abs(a - b).max(initial=0) <= 1


def _meta_json(raw):
    """A /v1/metadata answer without the encoder stamps (the fingerprint is
    sized there, not inlined)."""
    d = json.loads(raw)
    for k in ("flo_encoder_version", "encoding_time"):
        d.pop(k, None)
    return d


class TestService:
    def test_version(self, server_url):
        status, body = _get(server_url, "/v1/version")
        assert status == 200 and json.loads(body) == {"version": "1.2"}
        assert body == _ref("/v1/version")[1]

    def test_encode_decode_roundtrip(self, server_url):
        s = sine(220, 4000, 1.0, channels=2)
        q = "/v1/encode?sample_rate=4000&channels=2"
        _, _, flo = _post(server_url, q, s.astype("<f4").tobytes())
        assert flo[:4] == b"FLO!"
        assert _data_chunk(flo) == _data_chunk(_ref(q, s.astype("<f4").tobytes())[1])
        _, headers, raw = _post(server_url, "/v1/decode", flo)
        assert headers["X-Sample-Rate"] == "4000" and headers["X-Channels"] == "2"
        _, ref_raw, ref_headers = _ref("/v1/decode", flo)
        assert raw == ref_raw and ref_headers == {"X-Sample-Rate": "4000", "X-Channels": "2"}
        assert np.abs(np.frombuffer(raw, "<f4") - s).max() <= 1 / 32768 + 1e-6

    def test_encode_lossy_and_info(self, server_url):
        s = sine(220, 8000, 1.0)
        q = "/v1/encode_lossy?sample_rate=8000&channels=1&quality=2"
        _, _, flo = _post(server_url, q, s.astype("<f4").tobytes())
        ref_flo = _ref(q, s.astype("<f4").tobytes())[1]
        assert abs(len(flo) - len(ref_flo)) <= 0.01 * len(ref_flo)
        _, _, body = _post(server_url, "/v1/info", flo)
        info = json.loads(body)
        assert info["is_lossy"] and info["sample_rate"] == 8000
        assert body == _ref("/v1/info", flo)[1]
        _within_one_step(_post(server_url, "/v1/decode", flo)[2], _ref("/v1/decode", flo)[1])

    def test_validate_and_metadata(self, server_url):
        flo = encode(sine(100, 2000, 0.5), 2000, analyze=True)
        _, _, body = _post(server_url, "/v1/validate", flo)
        assert json.loads(body)["valid"] is True and body == _ref("/v1/validate", flo)[1]
        _, _, body = _post(server_url, "/v1/metadata", flo)
        assert "length_ms" in json.loads(body)
        assert body == _ref("/v1/metadata", flo)[1]

    def test_metadata_update_roundtrip(self, server_url):
        s = sine(100, 2000, 0.5)
        flo = encode(s, 2000)
        patch = json.dumps({"title": "Served", "artist": "Band"}).encode()
        body = struct.pack("<I", len(flo)) + flo + patch
        _, _, updated = _post(server_url, "/v1/metadata/update", body)
        assert updated == _ref("/v1/metadata/update", body)[1]
        meta = flo_torch.get_metadata(updated)
        assert meta.title == "Served" and meta.artist == "Band"
        assert _data_chunk(updated) == _data_chunk(flo)
        _, _, stripped = _post(server_url, "/v1/metadata/strip", updated)
        assert not flo_torch.has_metadata(stripped)
        assert stripped == _ref("/v1/metadata/strip", updated)[1]

    def test_decode_wav(self, server_url):
        flo = encode(sine(100, 2000, 0.5), 2000)
        _, _, wav = _post(server_url, "/v1/decode_wav", flo)
        assert wav[:4] == b"RIFF" and wav[8:12] == b"WAVE"
        assert wav == _ref("/v1/decode_wav", flo)[1]

    def test_encode_file_wav_input(self, server_url):
        s = sine(330, 4000, 0.5, channels=2)
        wav = audio_io.write_wav_to_bytes(s, 4000, 2)
        _, _, flo = _post(server_url, "/v1/encode_file?level=5", wav)
        ref_flo = _ref("/v1/encode_file?level=5", wav)[1]
        assert flo[:4] == b"FLO!" and _data_chunk(flo) == _data_chunk(ref_flo)
        assert _meta_json(_post(server_url, "/v1/metadata", flo)[2]) == _meta_json(
            _ref("/v1/metadata", ref_flo)[1])
        out = flo_torch.decode(flo, device="cpu")
        assert np.abs(out - s).max() <= 1 / 32768 + 1e-6

    def test_encode_file_lossy_and_bitrate(self, server_url):
        s = sine(330, 8000, 0.5, channels=2)
        wav = audio_io.write_wav_to_bytes(s, 8000, 2)
        for qs in ("quality=2", "bitrate_kbps=128"):
            _, _, flo = _post(server_url, f"/v1/encode_file?{qs}", wav)
            ref_flo = _ref(f"/v1/encode_file?{qs}", wav)[1]
            assert flo[:4] == b"FLO!"
            assert abs(len(flo) - len(ref_flo)) <= 0.01 * len(ref_flo)
            status, _, body = _post(server_url, "/v1/info", flo)
            assert status == 200 and json.loads(body)["is_lossy"]

    def test_seek(self, server_url):
        flo = encode(sine(100, 2000, 3.0), 2000)
        _, _, body = _post(server_url, "/v1/seek?time_ms=1500", flo)
        res = json.loads(body)
        assert res["frame_index"] == 1 and res["sample_offset"] == 1000
        assert body == _ref("/v1/seek?time_ms=1500", flo)[1]

    def test_analysis(self, server_url):
        flo = encode(sine(440, 8000, 1.0), 8000)
        q = "/v1/analysis?waveform=1&spectrum=1"
        out = json.loads(_post(server_url, q, flo)[2])
        ref = json.loads(_ref(q, flo)[1])
        assert out["sample_rate"] == 8000 and out["loudness"]["integrated_lufs"] < 0
        assert len(out["waveform"]["peaks"]) > 0
        assert len(out["spectrum"]["energy_profile"]) == 16
        out["spectrum"].pop("hash"), ref["spectrum"].pop("hash")
        assert out == ref

    def test_errors(self, server_url):
        assert _status(_post, server_url, "/v1/nope") == 404 == _ref_status("/v1/nope")
        q = "/v1/encode?sample_rate=100"
        assert _status(_post, server_url, q) == 400 == _ref_status(q)

    def test_codec_request_holds_the_lock_and_version_does_not(self, server_url, monkeypatch):
        """Codec endpoints run under _CODEC_LOCK (one device serves them all);
        /v1/version answers outside it. (flo_tpu's shape buckets stay
        behind: the port compiles nothing per shape.)"""
        seen = {}
        real = service._handle

        def spy(path, query, body, device):
            seen[path] = (service._CODEC_LOCK.locked(), str(device))
            return real(path, query, body, device)

        monkeypatch.setattr(service, "_handle", spy)
        _post(server_url, "/v1/encode?sample_rate=2000&channels=1",
              sine(100, 2000, 0.2).tobytes())
        _get(server_url, "/v1/version")
        assert seen == {"/v1/encode": (True, "cpu"), "/v1/version": (False, "cpu")}

    def test_cover_art_404(self, server_url):
        flo = encode(sine(100, 2000, 0.2), 2000)
        assert _status(_post, server_url, "/v1/cover_art", flo) == 404
        assert _ref_status("/v1/cover_art", flo) == 404


class TestDemoPage:
    def test_demo_served(self, server_url):
        status, body = _get(server_url, "/demo")
        assert status == 200
        html = body.decode()
        assert "<!doctype html>" in html and "/v1/encode_file" in html
        assert "<title>flo_torch demo</title>" in html
        assert body == _ref("/demo")[1].replace(b"flo_tpu demo", b"flo_torch demo")
        status2, body2 = _get(server_url, "/")
        assert status2 == 200 and body2 == body


def test_version_and_demo_bypass_codec_lock(server_url):
    """Health probes answer while a codec request holds the lock."""
    import socket

    with service._CODEC_LOCK:
        old = socket.getdefaulttimeout()
        socket.setdefaulttimeout(10)
        try:
            status, body = _get(server_url, "/v1/version")
            assert status == 200 and json.loads(body)["version"] == flo_torch.version()
            status, body = _get(server_url, "/demo")
            assert status == 200 and b"<html" in body.lower()
        finally:
            socket.setdefaulttimeout(old)


class TestRequestValidation:
    def test_bad_query_parameter_is_400_not_500(self, server_url):
        q = "/v1/encode?sample_rate=abc&channels=2"
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(server_url, q, sine(440, 8000, 0.2).tobytes())
        assert e.value.code == 400 == _ref_status(q, sine(440, 8000, 0.2).tobytes())
        assert "sample_rate" in json.loads(e.value.read())["error"]

    def test_bad_float_quality_is_400(self, server_url):
        q = "/v1/encode_transform?sample_rate=8000&channels=1&quality=hi"
        body = sine(440, 8000, 0.2).tobytes()
        assert _status(_post, server_url, q, body) == 400 == _ref_status(q, body)

    def test_encode_transform_roundtrip(self, server_url):
        samples = sine(440, 8000, 0.5)
        q = "/v1/encode_transform?sample_rate=8000&channels=1&quality=0.7"
        status, _, data = _post(server_url, q, samples.tobytes())
        assert status == 200 and data[:4] == b"FLO!"
        ref_data = _ref(q, samples.tobytes())[1]
        assert abs(len(data) - len(ref_data)) <= 0.01 * len(ref_data)
        status, headers, raw = _post(server_url, "/v1/decode", data)
        assert status == 200 and int(headers["X-Sample-Rate"]) == 8000
        assert np.frombuffer(raw, "<f4").size >= samples.size
        _within_one_step(raw, _ref("/v1/decode", data)[1])


class TestStreamingSessions:
    def test_decoder_session_chunked_feed(self, server_url):
        s = sine(330, 4000, 1.6, channels=2)
        flo = encode(s, 4000, 2)
        _, _, body = _post(server_url, "/v1/stream/decoder")
        sid = json.loads(body)["session"]
        _, body0 = _get(server_url, f"/v1/stream/{sid}/state")
        assert json.loads(body0)["state"] == "waiting_for_header"

        got = []
        for i in range(0, len(flo), 997):
            _, _, st = _post(server_url, f"/v1/stream/{sid}/feed", flo[i : i + 997])
            while True:
                status, headers, raw = _post(server_url, f"/v1/stream/{sid}/next_frame")
                if status == 204:
                    break
                got.append(np.frombuffer(raw, "<f4"))
        state = json.loads(st)
        assert state["state"] in ("ready", "finished")
        assert state["info"]["sample_rate"] == 4000
        assert np.concatenate(got).tobytes() == _ref("/v1/decode", flo)[1]

        _, _, body = _post(server_url, f"/v1/stream/{sid}/close")
        assert json.loads(body)["closed"] is True
        assert _status(_post, server_url, f"/v1/stream/{sid}/feed", b"x") == 404

    def test_decoder_session_error_state_and_reset(self, server_url):
        _, _, body = _post(server_url, "/v1/stream/decoder")
        sid = json.loads(body)["session"]
        _, _, st = _post(server_url, f"/v1/stream/{sid}/feed", b"NOPE" + b"\0" * 80)
        assert json.loads(st)["state"] == "error"
        assert _status(_post, server_url, f"/v1/stream/{sid}/feed", b"more") == 409
        _, _, st = _post(server_url, f"/v1/stream/{sid}/reset")
        assert json.loads(st)["state"] == "waiting_for_header"
        _post(server_url, f"/v1/stream/{sid}/close")

    def _both_sessions(self, server_url, create):
        sid = json.loads(_post(server_url, create)[2])["session"]
        ref_sid = json.loads(_ref(create)[1])["session"]
        return sid, ref_sid

    def test_encoder_session_finalize(self, server_url):
        s = sine(220, 2000, 2.3)  # 2 full frames + a partial tail
        sid, ref_sid = self._both_sessions(
            server_url, "/v1/stream/encoder?sample_rate=2000&channels=1&level=5")
        for i in range(0, len(s), 1500):
            piece = s[i : i + 1500].astype("<f4").tobytes()
            _, _, st = _post(server_url, f"/v1/stream/{sid}/push", piece)
            assert st == _ref(f"/v1/stream/{ref_sid}/push", piece)[1]
        assert json.loads(st)["pending_frames"] == 2
        status, _, flo = _post(server_url, f"/v1/stream/{sid}/finalize")
        assert status == 200 and flo[:4] == b"FLO!"
        assert flo == _ref(f"/v1/stream/{ref_sid}/finalize")[1]
        out = flo_torch.decode(flo, device="cpu")
        assert np.abs(out - s).max() <= 1 / 32768 + 1e-6
        assert _status(_get, server_url, f"/v1/stream/{sid}/state") == 404

    def test_encoder_session_drain_and_flush(self, server_url):
        s = sine(180, 2000, 1.4).astype("<f4").tobytes()
        sid, ref_sid = self._both_sessions(
            server_url, "/v1/stream/encoder?sample_rate=2000&channels=1")
        _post(server_url, f"/v1/stream/{sid}/push", s)
        _ref(f"/v1/stream/{ref_sid}/push", s)
        status, headers, frame0 = _post(server_url, f"/v1/stream/{sid}/next_frame")
        _, ref0, ref_headers = _ref(f"/v1/stream/{ref_sid}/next_frame")
        assert status == 200 and headers["X-Frame-Index"] == "0"
        assert int(headers["X-Samples"]) == 2000 and frame0 == ref0
        assert {k: headers[k] for k in ref_headers} == ref_headers
        status, _, _ = _post(server_url, f"/v1/stream/{sid}/next_frame")
        assert status == 204
        status, headers, tail = _post(server_url, f"/v1/stream/{sid}/flush")
        _ref(f"/v1/stream/{ref_sid}/next_frame")
        assert status == 200 and int(headers["X-Samples"]) == 800
        assert tail == _ref(f"/v1/stream/{ref_sid}/flush")[1]
        status, _, _ = _post(server_url, f"/v1/stream/{sid}/flush")
        assert status == 204
        _post(server_url, f"/v1/stream/{sid}/close")
        _ref(f"/v1/stream/{ref_sid}/close")

    def test_session_cap(self, server_url):
        old_sessions = dict(service._SESSIONS)
        try:
            service._SESSIONS.clear()
            for _ in range(service._MAX_SESSIONS):
                _post(server_url, "/v1/stream/decoder")
            assert _status(_post, server_url, "/v1/stream/decoder") == 429
        finally:
            service._SESSIONS.clear()
            service._SESSIONS.update(old_sessions)
        assert service._MAX_SESSIONS == tpu_service._MAX_SESSIONS

    def test_idle_sessions_evicted_at_cap(self, server_url):
        old_sessions = dict(service._SESSIONS)
        try:
            service._SESSIONS.clear()
            _, _, body = _post(server_url, "/v1/stream/decoder")
            stale = json.loads(body)["session"]
            service._SESSIONS[stale][1] -= service._SESSION_IDLE_TTL_S + 1
            for _ in range(service._MAX_SESSIONS - 1):
                _post(server_url, "/v1/stream/decoder")
            _, _, body = _post(server_url, "/v1/stream/decoder")  # evicts stale
            assert "session" in json.loads(body)
            assert stale not in service._SESSIONS
        finally:
            service._SESSIONS.clear()
            service._SESSIONS.update(old_sessions)


def test_toc_endpoint(server_url):
    flo = encode(sine(100, 2000, 3.0), 2000)
    _, _, body = _post(server_url, "/v1/toc", flo)
    toc = json.loads(body)
    assert [e["frame_index"] for e in toc] == [0, 1, 2]
    assert [e["timestamp_ms"] for e in toc] == [0, 1000, 2000]
    assert toc[1]["byte_offset"] == toc[0]["byte_offset"] + toc[0]["frame_size"]
    assert body == _ref("/v1/toc", flo)[1]


class TestSeekAndMetadataEndpoints:
    def test_decode_frame(self, server_url):
        flo = encode(sine(150, 2000, 3.0), 2000)
        full = np.asarray(flo_torch.decode(flo, device="cpu"), np.float32)
        _, _, raw = _post(server_url, "/v1/decode_frame?frame_index=1", flo)
        np.testing.assert_array_equal(np.frombuffer(raw, "<f4"), full[2000:4000])
        assert raw == _ref("/v1/decode_frame?frame_index=1", flo)[1]

    def test_decode_frame_lossy(self, server_url):
        flo = flo_torch.encode_lossy(sine(150, 8000, 0.6), 8000, 1, 2, device="cpu")
        for i in (0, 2):
            q = f"/v1/decode_frame?frame_index={i}"
            _within_one_step(_post(server_url, q, flo)[2], _ref(q, flo)[1])

    def test_metadata_create_and_raw(self, server_url):
        obj = {
            "title": "Session Take",
            "artist": "Us",
            "bpm": 128.0,
            "section_markers": [
                {"timestamp_ms": 0, "section_type": "intro", "label": None},
                {"timestamp_ms": 30000, "section_type": "chorus", "label": "hook"},
            ],
        }
        body = json.dumps(obj).encode()
        _, headers, packed = _post(server_url, "/v1/metadata/create", body)
        assert headers["Content-Type"] == "application/msgpack"
        assert packed == _ref("/v1/metadata/create", body)[1]

        s = sine(200, 2000, 1.0)
        _, _, created = _post(server_url, "/v1/stream/encoder?sample_rate=2000&channels=1")
        sid = json.loads(created)["session"]
        _post(server_url, f"/v1/stream/{sid}/push", s.astype("<f4").tobytes())
        _, _, flo = _post(server_url, f"/v1/stream/{sid}/finalize", packed)
        got = flo_torch.get_metadata(flo)
        assert got.title == "Session Take" and len(got.section_markers) == 2
        _, _, raw = _post(server_url, "/v1/metadata?raw=1", flo)
        assert raw == packed == _ref("/v1/metadata?raw=1", flo)[1]

    def test_metadata_update_nested_structures(self, server_url):
        flo = encode(sine(100, 2000, 0.5), 2000)
        patch = json.dumps({
            "title": "T",
            "section_markers": [{"timestamp_ms": 0, "section_type": "intro", "label": None}],
        }).encode()
        body = struct.pack("<I", len(flo)) + flo + patch
        _, _, updated = _post(server_url, "/v1/metadata/update", body)
        assert updated == _ref("/v1/metadata/update", body)[1]
        meta = flo_torch.get_metadata(updated)
        assert meta.title == "T" and meta.section_markers[0].section_type.value == "intro"


class TestAnalysisEndpoints:
    def test_similarity(self, server_url):
        fa, fb, fc = (encode(sine(f, 8000, 1.0), 8000) for f in (440, 445, 3000))

        def sim(x, y):
            body = struct.pack("<I", len(x)) + x + y
            out = json.loads(_post(server_url, "/v1/similarity", body)[2])["similarity"]
            assert out == json.loads(_ref("/v1/similarity", body)[1])["similarity"]
            return out

        assert sim(fa, fa) == 1.0
        assert sim(fa, fb) > sim(fa, fc)

    def test_dominant_frequencies(self, server_url):
        flo = encode(sine(440, 8000, 1.0), 8000)
        _, _, out = _post(server_url, "/v1/dominant_frequencies?num=3", flo)
        frames = json.loads(out)
        assert frames and len(frames[0]) == 3 and all(0 <= f <= 4000 for f in frames[0])
        assert out == _ref("/v1/dominant_frequencies?num=3", flo)[1]

    def test_similarity_bad_framing(self, server_url):
        body = struct.pack("<I", 999) + b"x"
        assert _status(_post, server_url, "/v1/similarity", body) == 400
        assert _ref_status("/v1/similarity", body) == 400


class TestInfoEndpoints:
    def test_audio_info(self, server_url):
        wav = audio_io.write_wav_to_bytes(sine(330, 4000, 1.5, channels=2), 4000, 2)
        _, _, body = _post(server_url, "/v1/audio_info", wav)
        assert json.loads(body) == {"sample_rate": 4000, "channels": 2, "duration_secs": 1.5}
        assert body == _ref("/v1/audio_info", wav)[1]

    def test_encoding_info(self, server_url):
        wav = audio_io.write_wav_to_bytes(sine(330, 4000, 0.5), 4000, 1)
        flo = reflo.encode_from_audio(wav, reflo.EncodeOptions.lossless(), device="cpu")
        info = json.loads(_post(server_url, "/v1/encoding_info", flo)[2])
        assert info["source_format"] == "WAV"
        assert info["encoder_version"].startswith("flo_torch")
        assert info == json.loads(_ref("/v1/encoding_info", flo)[1])
        bare = encode(sine(330, 4000, 0.5), 4000)
        assert json.loads(_post(server_url, "/v1/encoding_info", bare)[2]) is None


class TestHardening:
    def test_oversize_content_length_is_413_before_read(self, server_url):
        import http.client

        host, port = server_url.replace("http://", "").split(":")
        conn = http.client.HTTPConnection(host, int(port), timeout=10)
        try:
            conn.putrequest("POST", "/v1/encode?sample_rate=8000&channels=1")
            conn.putheader("Content-Length", str(service._MAX_BODY_BYTES + 1))
            conn.endheaders()
            resp = conn.getresponse()
            assert resp.status == 413
            assert "exceeds" in json.loads(resp.read())["error"]
        finally:
            conn.close()
        assert service._MAX_BODY_BYTES == tpu_service._MAX_BODY_BYTES

    def test_garbage_content_length_is_400(self, server_url):
        import http.client

        host, port = server_url.replace("http://", "").split(":")
        conn = http.client.HTTPConnection(host, int(port), timeout=10)
        try:
            conn.putrequest("POST", "/v1/version")
            conn.putheader("Content-Length", "banana")
            conn.endheaders()
            assert conn.getresponse().status == 400
        finally:
            conn.close()

    def test_f32_body_not_multiple_of_4_is_400(self, server_url):
        for path in ("/v1/encode?sample_rate=8000&channels=1",
                     "/v1/encode_lossy?sample_rate=8000&channels=1"):
            with pytest.raises(urllib.error.HTTPError) as e:
                _post(server_url, path, b"\x00" * 7)
            assert e.value.code == 400 == _ref_status(path, b"\x00" * 7)
            assert "multiple of 4" in json.loads(e.value.read())["error"]

    def test_stream_encoder_create_validates_ranges(self, server_url):
        for qs in ("sample_rate=0&channels=2", "sample_rate=-8000&channels=2",
                   "sample_rate=8000&channels=0", "sample_rate=8000&channels=9",
                   "sample_rate=8000&channels=2&bit_depth=12",
                   "sample_rate=8000&channels=2&level=11"):
            path = f"/v1/stream/encoder?{qs}"
            assert _status(_post, server_url, path) == 400 == _ref_status(path), qs

    def test_stream_push_odd_body_is_400(self, server_url):
        sid = json.loads(_post(server_url, "/v1/stream/encoder?sample_rate=8000&channels=1")[2])[
            "session"]
        try:
            assert _status(_post, server_url, f"/v1/stream/{sid}/push", b"\x00" * 6) == 400
        finally:
            _post(server_url, f"/v1/stream/{sid}/close")

    def test_session_buffer_cap_is_413(self, server_url, monkeypatch):
        monkeypatch.setattr(service, "_MAX_SESSION_BUFFER_BYTES", 64)
        sid = json.loads(_post(server_url, "/v1/stream/decoder")[2])["session"]
        try:
            assert _status(_post, server_url, f"/v1/stream/{sid}/feed", b"\x00" * 65) == 413
            sid2 = json.loads(
                _post(server_url, "/v1/stream/encoder?sample_rate=8000&channels=1")[2])["session"]
            assert _status(_post, server_url, f"/v1/stream/{sid2}/push", b"\x00" * 68) == 413
            _post(server_url, f"/v1/stream/{sid2}/close")
        finally:
            _post(server_url, f"/v1/stream/{sid}/close")

    def test_idle_sessions_evicted_below_cap(self, server_url, monkeypatch):
        sid = json.loads(_post(server_url, "/v1/stream/decoder")[2])["session"]
        monkeypatch.setattr(service, "_SESSION_IDLE_TTL_S", -1)
        _post(server_url, "/v1/stream/decoder")  # any stream request sweeps
        monkeypatch.setattr(service, "_SESSION_IDLE_TTL_S", 15 * 60)
        assert _status(_get, server_url, f"/v1/stream/{sid}/state") == 404

    def test_similarity_empty_segment_is_400(self, server_url):
        flo = encode(sine(100, 2000, 0.2), 2000)
        for framed in (struct.pack("<I", 0) + flo, struct.pack("<I", len(flo)) + flo):
            assert _status(_post, server_url, "/v1/similarity", framed) == 400
            assert _ref_status("/v1/similarity", framed) == 400

    def test_serve_defaults_to_loopback_and_cuda(self):
        import inspect

        params = inspect.signature(service.serve).parameters
        assert params["host"].default == "127.0.0.1" and params["device"].default == "cuda"
        assert inspect.signature(service.make_server).parameters["device"].default == "cuda"

    def test_make_server_without_a_card_raises(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            service.make_server("127.0.0.1", 0)
