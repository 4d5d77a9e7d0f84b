"""Browser demo page for the HTTP service (`GET /demo`).

The reference ships a browser demo that hosts the WASM codec in a web
worker (Demo/js/*, SURVEY.md §2.8). In this build the codec runs
server-side (PyTorch, on the card), so the demo is a static page driving the HTTP
endpoints instead of a WASM module — same user-visible feature set:
encode an uploaded audio file (lossless level / lossy preset / target
bitrate), inspect info + metadata + EBU R128 loudness, render the
waveform, play the decoded result, and download the .flo / .wav bytes.
The streaming section mirrors Demo/js/streaming.js: the encoded file is
fed to a `/v1/stream/decoder` session in small network-sized chunks and
each frame plays through Web Audio as soon as it decodes.

Kept in one self-contained HTML string: no external assets, no CDN, so
`flo-torch serve` works in an air-gapped deployment. The page itself is
flo_tpu's, with its own title; its `fetch` calls use relative `/v1/...` paths.
"""

PAGE = r"""<!doctype html>
<html lang="en">
<head>
<meta charset="utf-8">
<title>flo_torch demo</title>
<meta name="viewport" content="width=device-width, initial-scale=1">
<style>
  :root { color-scheme: light dark; }
  body { font: 15px/1.45 system-ui, sans-serif; max-width: 880px;
         margin: 2rem auto; padding: 0 1rem; }
  h1 { font-size: 1.3rem; } h2 { font-size: 1.05rem; margin-top: 1.6rem; }
  fieldset { border: 1px solid #8884; border-radius: 8px; margin: .8rem 0; }
  label { margin-right: 1rem; }
  button { padding: .35rem .9rem; border-radius: 6px; cursor: pointer; }
  #wave { width: 100%; height: 96px; background: #8881; border-radius: 6px; }
  pre { background: #8881; padding: .6rem; border-radius: 6px;
        overflow-x: auto; font-size: .82rem; }
  .row { display: flex; gap: 1rem; flex-wrap: wrap; align-items: center; }
  .stat { padding: .4rem .8rem; background: #8881; border-radius: 6px; }
  .stat b { display: block; font-size: 1.05rem; }
  #err { color: #c33; white-space: pre-wrap; }
</style>
</head>
<body>
<h1>flo™ codec demo <small>(TPU service build)</small></h1>
<p>Pick an audio file (WAV, AIFF, FLAC, Ogg Vorbis, MP3, or an existing
.flo), choose a mode, and encode. Everything runs on the server via the
<code>/v1</code> API this page is served from.</p>

<fieldset><legend>Input</legend>
  <input type="file" id="file">
</fieldset>

<fieldset><legend>Mode</legend>
  <div class="row">
    <label><input type="radio" name="mode" value="lossless" checked> Lossless
      level <input type="number" id="level" value="5" min="0" max="9" style="width:3.5em"></label>
    <label><input type="radio" name="mode" value="lossy"> Lossy quality
      <select id="quality">
        <option value="0">low</option><option value="1">medium</option>
        <option value="2" selected>high</option><option value="3">veryhigh</option>
        <option value="4">transparent</option>
      </select></label>
    <label><input type="radio" name="mode" value="bitrate"> Bitrate
      <input type="number" id="kbps" value="128" min="32" max="512" style="width:4.5em"> kbps</label>
  </div>
</fieldset>

<div class="row">
  <button id="go">Encode</button>
  <button id="dlflo" disabled>Download .flo</button>
  <button id="dlwav" disabled>Download .wav</button>
  <span id="busy" hidden>working…</span>
</div>
<p id="err"></p>

<h2>Result</h2>
<div class="row" id="stats"></div>
<canvas id="wave" width="1720" height="192"></canvas>
<audio id="player" controls style="width:100%"></audio>

<h2>Streaming playback</h2>
<p>Feeds the encoded file to a server-side streaming-decoder session in
small chunks (simulated network delivery) and plays each frame as soon as
its bytes arrive — the push-based API the reference demo exercises.</p>
<div class="row">
  <button id="streamgo" disabled>Stream &amp; play</button>
  <button id="streamstop" disabled>Stop</button>
  <span class="stat" id="streamstat">idle</span>
</div>

<h2>Metadata</h2>
<pre id="meta">—</pre>

<script>
"use strict";
const $ = id => document.getElementById(id);
let floBytes = null, wavUrl = null;

async function api(path, body, asJson) {
  const r = await fetch(path, {method: "POST", body});
  if (!r.ok) {
    let msg = r.status + " " + r.statusText;
    try { msg = (await r.json()).error || msg; } catch (e) {}
    throw new Error(path + ": " + msg);
  }
  return asJson ? r.json() : new Uint8Array(await r.arrayBuffer());
}

function stat(label, value) {
  return `<span class="stat"><b>${value}</b>${label}</span>`;
}

function drawWave(peaks) {
  const c = $("wave"), g = c.getContext("2d");
  g.clearRect(0, 0, c.width, c.height);
  g.fillStyle = getComputedStyle(document.body).color;
  g.globalAlpha = 0.75;
  const n = peaks.length, w = c.width / n, mid = c.height / 2;
  for (let i = 0; i < n; i++) {
    const h = Math.max(1, peaks[i] * (c.height - 4));
    g.fillRect(i * w, mid - h / 2, Math.max(1, w - 1), h);
  }
  g.globalAlpha = 1;
}

$("go").onclick = async () => {
  const f = $("file").files[0];
  $("err").textContent = "";
  if (!f) { $("err").textContent = "pick a file first"; return; }
  $("busy").hidden = false; $("go").disabled = true;
  try {
    const src = new Uint8Array(await f.arrayBuffer());
    const isFlo = src.length > 4 && src[0] == 70 && src[1] == 76 &&
                  src[2] == 79 && src[3] == 33; // "FLO!"
    const mode = document.querySelector("input[name=mode]:checked").value;
    const q = mode === "lossless" ? "level=" + $("level").value
            : mode === "lossy" ? "quality=" + $("quality").value
            : "bitrate_kbps=" + $("kbps").value;
    floBytes = isFlo ? src : await api("/v1/encode_file?" + q, src);

    const [info, meta, analysis] = [
      await api("/v1/info", floBytes, true),
      await api("/v1/metadata", floBytes, true),
      await api("/v1/analysis?waveform=1", floBytes, true),
    ];
    $("stats").innerHTML =
      stat("input bytes", src.length.toLocaleString()) +
      stat("flo bytes", floBytes.length.toLocaleString()) +
      stat("ratio", (info.compression_ratio || 0).toFixed(2) + "×") +
      stat("duration", (info.duration_secs || 0).toFixed(2) + " s") +
      stat("rate", info.sample_rate + " Hz ×" + info.channels) +
      stat("CRC", info.crc_valid ? "valid" : "BAD") +
      stat("LUFS", analysis.loudness.integrated_lufs.toFixed(1)) +
      stat("true peak", analysis.loudness.true_peak_dbtp.toFixed(1) + " dBTP");
    $("meta").textContent = JSON.stringify(meta, null, 2);
    if (analysis.waveform) drawWave(analysis.waveform.peaks);

    const wav = await api("/v1/decode_wav", floBytes);
    if (wavUrl) URL.revokeObjectURL(wavUrl);
    wavUrl = URL.createObjectURL(new Blob([wav], {type: "audio/wav"}));
    $("player").src = wavUrl;
    $("dlflo").disabled = $("dlwav").disabled = $("streamgo").disabled = false;
  } catch (e) {
    $("err").textContent = String(e);
  } finally {
    $("busy").hidden = true; $("go").disabled = false;
  }
};

function download(url, name) {
  const a = document.createElement("a");
  a.href = url; a.download = name; a.click();
}
$("dlflo").onclick = () => {
  const u = URL.createObjectURL(new Blob([floBytes]));
  download(u, "encoded.flo"); setTimeout(() => URL.revokeObjectURL(u), 5000);
};
$("dlwav").onclick = () => download(wavUrl, "decoded.wav");

// ---- Streaming playback (Demo/js/streaming.js analog) ----
let streamAbort = false;
$("streamstop").onclick = () => { streamAbort = true; };
$("streamgo").onclick = async () => {
  const CHUNK = 16384;
  streamAbort = false;
  $("streamgo").disabled = true; $("streamstop").disabled = false;
  $("err").textContent = "";
  let sid = null, ctx = null;
  try {
    sid = (await api("/v1/stream/decoder", null, true)).session;
    let info = null, playT = 0, frames = 0;
    for (let off = 0; off < floBytes.length && !streamAbort; off += CHUNK) {
      const st = await api(`/v1/stream/${sid}/feed`,
                           floBytes.slice(off, off + CHUNK), true);
      if (!info && st.info) {
        info = st.info;
        ctx = new (window.AudioContext || window.webkitAudioContext)(
          {sampleRate: info.sample_rate});
        playT = ctx.currentTime + 0.15;  // small jitter buffer
      }
      for (;;) {  // drain every frame whose bytes have now arrived
        const r = await fetch(`/v1/stream/${sid}/next_frame`, {method: "POST"});
        if (r.status === 204) break;
        if (!r.ok) throw new Error("next_frame: " + r.status);
        const inter = new Float32Array(await r.arrayBuffer());
        const ch = info.channels, n = inter.length / ch;
        const buf = ctx.createBuffer(ch, n, info.sample_rate);
        for (let c = 0; c < ch; c++) {
          const d = buf.getChannelData(c);
          for (let i = 0; i < n; i++) d[i] = inter[i * ch + c];
        }
        const src = ctx.createBufferSource();
        src.buffer = buf; src.connect(ctx.destination);
        playT = Math.max(playT, ctx.currentTime);
        src.start(playT); playT += n / info.sample_rate;
        frames++;
        $("streamstat").textContent =
          `fed ${Math.min(off + CHUNK, floBytes.length)} / ${floBytes.length} B, ` +
          `played ${frames} frames`;
      }
    }
    $("streamstat").textContent += streamAbort ? " (stopped)" : " (done)";
    // Let the scheduled tail play out before closing the context.
    if (ctx && !streamAbort)
      await new Promise(res => setTimeout(res, 1000 * Math.max(0, playT - ctx.currentTime)));
  } catch (e) {
    $("err").textContent = String(e);
  } finally {
    if (ctx) ctx.close();
    if (sid) api(`/v1/stream/${sid}/close`).catch(() => {});
    $("streamgo").disabled = false; $("streamstop").disabled = true;
  }
};
</script>
</body>
</html>
"""
