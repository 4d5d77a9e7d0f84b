// AAC / M4A ingest via the system FFmpeg libraries (libavformat 59,
// libavcodec 59 — the versions shipped in this image).
//
// The reference ingests AAC by wrapping a third-party decoder library
// (Symphonia with the `aac` + `isomp4` features, reflo/Cargo.toml:31-41,
// reflo/src/audio.rs:57-166). This shim is the same design point for this
// environment: AAC's normative Huffman codebooks and window tables are
// opaque constant blobs that cannot be re-derived offline, so we wrap the
// battle-tested system decoder — exactly like mp3.py wraps
// libmpg123. A thin C++ layer (instead of ctypes struct mirroring) keeps us
// on the *public, versioned* FFmpeg API: struct layouts come from the
// system headers the libraries were built against, not hand-copied offsets.
//
// Exports (all plain C ABI, bound from native/__init__.py):
//   flo_ingest_decode(data, size)        -> opaque result handle
//   flo_ingest_error/rate/channels/nsamples/samples  -> accessors
//   flo_ingest_ntags/tag_key/tag_val     -> container+stream metadata dict
//   flo_ingest_cover_size/cover_mime/cover -> attached picture, if any
//   flo_ingest_encode_aac(...)           -> test-vector generator (ADTS/M4A)
//   flo_ingest_bytes_size/bytes          -> encoded-bytes accessors
//   flo_ingest_free(handle)
//
// The decoder is format-agnostic (anything libavformat probes), but the
// Python layer only routes AAC (ADTS) and MP4/M4A here — WAV/AIFF/FLAC/
// Vorbis/MP3 keep their existing from-spec / libmpg123 paths.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <string>
#include <utility>
#include <vector>

extern "C" {
#include <libavcodec/avcodec.h>
#include <libavformat/avformat.h>
#include <libavutil/channel_layout.h>
#include <libavutil/dict.h>
#include <libavutil/error.h>
#include <libavutil/log.h>
#include <libavutil/mem.h>
#include <libavutil/opt.h>
}

namespace {

// Keep FFmpeg's info/warning chatter (encoder Qavg lines, duration
// estimates) off the host process's stderr; real failures surface through
// return codes -> flo_ingest_error.
struct LogQuiet {
  LogQuiet() { av_log_set_level(AV_LOG_ERROR); }
};
const LogQuiet quiet_init;

constexpr int kIoBuf = 1 << 16;

struct MemReader {
  const uint8_t* data;
  int64_t size;
  int64_t pos;
};

int mem_read(void* opaque, uint8_t* buf, int buf_size) {
  auto* m = static_cast<MemReader*>(opaque);
  int64_t rem = m->size - m->pos;
  if (rem <= 0) return AVERROR_EOF;
  int n = static_cast<int>(std::min<int64_t>(buf_size, rem));
  std::memcpy(buf, m->data + m->pos, n);
  m->pos += n;
  return n;
}

int64_t mem_seek(void* opaque, int64_t offset, int whence) {
  auto* m = static_cast<MemReader*>(opaque);
  if (whence == AVSEEK_SIZE) return m->size;
  whence &= ~AVSEEK_FORCE;
  int64_t np = whence == SEEK_SET   ? offset
               : whence == SEEK_CUR ? m->pos + offset
                                    : m->size + offset;
  if (np < 0 || np > m->size) return AVERROR(EINVAL);
  m->pos = np;
  return np;
}

struct MemWriter {
  std::vector<uint8_t> buf;
  int64_t pos = 0;
};

// lavf 59's write callback takes non-const uint8_t* (constified in lavf 61).
int mem_write(void* opaque, uint8_t* data, int buf_size) {
  auto* m = static_cast<MemWriter*>(opaque);
  if (m->pos + buf_size > static_cast<int64_t>(m->buf.size()))
    m->buf.resize(m->pos + buf_size);
  std::memcpy(m->buf.data() + m->pos, data, buf_size);
  m->pos += buf_size;
  return buf_size;
}

int64_t memw_seek(void* opaque, int64_t offset, int whence) {
  auto* m = static_cast<MemWriter*>(opaque);
  if (whence == AVSEEK_SIZE) return static_cast<int64_t>(m->buf.size());
  whence &= ~AVSEEK_FORCE;
  int64_t np = whence == SEEK_SET   ? offset
               : whence == SEEK_CUR ? m->pos + offset
                                    : static_cast<int64_t>(m->buf.size()) + offset;
  if (np < 0) return AVERROR(EINVAL);
  m->pos = np;
  return np;
}

struct Result {
  std::vector<float> samples;  // interleaved
  int rate = 0;
  int channels = 0;
  std::string error;
  std::vector<std::pair<std::string, std::string>> tags;
  std::vector<uint8_t> cover;
  std::string cover_mime;
  std::vector<uint8_t> bytes;  // encode-path output
};

void set_error(Result* r, const char* what, int rc) {
  char msg[AV_ERROR_MAX_STRING_SIZE] = {0};
  av_strerror(rc, msg, sizeof msg);
  r->error = std::string(what) + ": " + msg;
}

// Planar/packed sample-format -> interleaved f32, same scales as the
// reference's sample conversion (audio.rs:238-275: s16/32768, etc.).
bool append_frame(Result* r, const AVFrame* f) {
  const int ch = f->ch_layout.nb_channels;
  const int ns = f->nb_samples;
  if (ch <= 0 || ns <= 0) return true;
  size_t base = r->samples.size();
  r->samples.resize(base + static_cast<size_t>(ns) * ch);
  float* out = r->samples.data() + base;
  const auto fmt = static_cast<AVSampleFormat>(f->format);
  const bool planar = av_sample_fmt_is_planar(fmt) != 0;
  const AVSampleFormat pk = av_get_packed_sample_fmt(fmt);

  auto plane = [&](int c) -> const uint8_t* {
    return planar ? f->extended_data[c] : f->extended_data[0];
  };
  auto idx = [&](int i, int c) -> int { return planar ? i : i * ch + c; };

  for (int c = 0; c < ch; ++c) {
    const uint8_t* p = plane(c);
    switch (pk) {
      case AV_SAMPLE_FMT_FLT:
        for (int i = 0; i < ns; ++i)
          out[i * ch + c] = reinterpret_cast<const float*>(p)[idx(i, c)];
        break;
      case AV_SAMPLE_FMT_DBL:
        for (int i = 0; i < ns; ++i)
          out[i * ch + c] = static_cast<float>(
              reinterpret_cast<const double*>(p)[idx(i, c)]);
        break;
      case AV_SAMPLE_FMT_S16:
        for (int i = 0; i < ns; ++i)
          out[i * ch + c] =
              reinterpret_cast<const int16_t*>(p)[idx(i, c)] / 32768.0f;
        break;
      case AV_SAMPLE_FMT_S32:
        for (int i = 0; i < ns; ++i)
          out[i * ch + c] = static_cast<float>(
              reinterpret_cast<const int32_t*>(p)[idx(i, c)] / 2147483648.0);
        break;
      case AV_SAMPLE_FMT_S64:
        for (int i = 0; i < ns; ++i)
          out[i * ch + c] = static_cast<float>(
              reinterpret_cast<const int64_t*>(p)[idx(i, c)] /
              9223372036854775808.0);
        break;
      case AV_SAMPLE_FMT_U8:
        for (int i = 0; i < ns; ++i)
          out[i * ch + c] = (p[idx(i, c)] - 128) / 128.0f;
        break;
      default:
        r->error = "unsupported decoded sample format";
        return false;
    }
  }
  return true;
}

void collect_tags(Result* r, const AVDictionary* d) {
  const AVDictionaryEntry* e = nullptr;
  while ((e = av_dict_get(d, "", e, AV_DICT_IGNORE_SUFFIX)) != nullptr) {
    std::string key(e->key);
    for (auto& c : key) c = static_cast<char>(std::tolower(c));
    bool dup = false;
    for (auto& kv : r->tags) dup |= kv.first == key;
    if (!dup) r->tags.emplace_back(std::move(key), e->value ? e->value : "");
  }
}

}  // namespace

extern "C" {

void* flo_ingest_decode(const uint8_t* data, int64_t size) {
  auto* res = new Result();
  MemReader mem{data, size, 0};
  AVFormatContext* fmt = nullptr;
  AVIOContext* avio = nullptr;
  AVCodecContext* cc = nullptr;
  AVPacket* pkt = nullptr;
  AVFrame* frm = nullptr;

  auto cleanup = [&]() {
    if (cc) avcodec_free_context(&cc);
    if (pkt) av_packet_free(&pkt);
    if (frm) av_frame_free(&frm);
    if (fmt) avformat_close_input(&fmt);
    if (avio) {
      av_freep(&avio->buffer);
      avio_context_free(&avio);
    }
  };

  uint8_t* iobuf = static_cast<uint8_t*>(av_malloc(kIoBuf));
  avio = avio_alloc_context(iobuf, kIoBuf, 0, &mem, mem_read, nullptr, mem_seek);
  fmt = avformat_alloc_context();
  fmt->pb = avio;
  fmt->flags |= AVFMT_FLAG_CUSTOM_IO;
  int rc = avformat_open_input(&fmt, nullptr, nullptr, nullptr);
  if (rc < 0) {
    set_error(res, "avformat_open_input", rc);
    fmt = nullptr;  // open_input frees the context on failure
    cleanup();
    return res;
  }
  rc = avformat_find_stream_info(fmt, nullptr);
  if (rc < 0) {
    set_error(res, "avformat_find_stream_info", rc);
    cleanup();
    return res;
  }
  const AVCodec* dec = nullptr;
  int si = av_find_best_stream(fmt, AVMEDIA_TYPE_AUDIO, -1, -1, &dec, 0);
  if (si < 0 || dec == nullptr) {
    set_error(res, "no decodable audio stream", si < 0 ? si : AVERROR_DECODER_NOT_FOUND);
    cleanup();
    return res;
  }
  cc = avcodec_alloc_context3(dec);
  avcodec_parameters_to_context(cc, fmt->streams[si]->codecpar);
  rc = avcodec_open2(cc, dec, nullptr);
  if (rc < 0) {
    set_error(res, "avcodec_open2", rc);
    cleanup();
    return res;
  }

  pkt = av_packet_alloc();
  frm = av_frame_alloc();
  bool flushed = false;
  while (!flushed) {
    rc = av_read_frame(fmt, pkt);
    if (rc < 0) {
      avcodec_send_packet(cc, nullptr);  // enter drain mode
      flushed = true;
    } else if (pkt->stream_index != si) {
      av_packet_unref(pkt);
      continue;
    } else {
      rc = avcodec_send_packet(cc, pkt);
      av_packet_unref(pkt);
      if (rc < 0 && rc != AVERROR(EAGAIN)) continue;  // skip corrupt packet
    }
    while (true) {
      rc = avcodec_receive_frame(cc, frm);
      if (rc == AVERROR(EAGAIN) || rc == AVERROR_EOF) break;
      if (rc < 0) {
        set_error(res, "avcodec_receive_frame", rc);
        cleanup();
        return res;
      }
      if (res->rate == 0) {
        res->rate = frm->sample_rate ? frm->sample_rate : cc->sample_rate;
        res->channels = frm->ch_layout.nb_channels;
      }
      if (!append_frame(res, frm)) {
        cleanup();
        return res;
      }
      av_frame_unref(frm);
    }
  }

  if (res->samples.empty() || res->rate <= 0 || res->channels <= 0) {
    if (res->error.empty()) res->error = "no decodable audio frames found";
    cleanup();
    return res;
  }

  collect_tags(res, fmt->metadata);
  collect_tags(res, fmt->streams[si]->metadata);
  for (unsigned i = 0; i < fmt->nb_streams; ++i) {
    AVStream* st = fmt->streams[i];
    if ((st->disposition & AV_DISPOSITION_ATTACHED_PIC) &&
        st->attached_pic.size > 0 && res->cover.empty()) {
      res->cover.assign(st->attached_pic.data,
                        st->attached_pic.data + st->attached_pic.size);
      const AVDictionaryEntry* m = av_dict_get(st->metadata, "mimetype", nullptr, 0);
      if (m && m->value) {
        res->cover_mime = m->value;
      } else if (st->codecpar->codec_id == AV_CODEC_ID_PNG) {
        res->cover_mime = "image/png";
      } else {
        res->cover_mime = "image/jpeg";
      }
    }
  }
  cleanup();
  return res;
}

// --- test-vector generator -------------------------------------------------
// Encodes interleaved f32 PCM with the system AAC encoder into an ADTS or
// MP4 (m4a) container, in memory. Exists so the test suite can create its
// own AAC inputs (the analog of tests/mp3_writer.py for MP3); not part of
// the framework's public surface.
void* flo_ingest_encode_aac(const float* samples, int64_t n_interleaved,
                            int rate, int channels, const char* container,
                            const char* title, const char* artist) {
  auto* res = new Result();
  const AVCodec* enc = avcodec_find_encoder_by_name("aac");
  const AVOutputFormat* of = av_guess_format(container, nullptr, nullptr);
  if (!enc || !of) {
    res->error = "aac encoder / muxer unavailable";
    return res;
  }

  AVFormatContext* fmt = nullptr;
  AVCodecContext* cc = nullptr;
  AVIOContext* avio = nullptr;
  AVPacket* pkt = nullptr;
  AVFrame* frm = nullptr;
  MemWriter mw;

  auto cleanup = [&]() {
    if (cc) avcodec_free_context(&cc);
    if (pkt) av_packet_free(&pkt);
    if (frm) av_frame_free(&frm);
    if (fmt) avformat_free_context(fmt);
    if (avio) {
      av_freep(&avio->buffer);
      avio_context_free(&avio);
    }
  };

  avformat_alloc_output_context2(&fmt, of, nullptr, nullptr);
  AVStream* st = avformat_new_stream(fmt, nullptr);
  cc = avcodec_alloc_context3(enc);
  cc->sample_rate = rate;
  av_channel_layout_default(&cc->ch_layout, channels);
  cc->sample_fmt = AV_SAMPLE_FMT_FLTP;
  cc->bit_rate = 128000;
  cc->time_base = AVRational{1, rate};
  if (fmt->oformat->flags & AVFMT_GLOBALHEADER)
    cc->flags |= AV_CODEC_FLAG_GLOBAL_HEADER;
  int rc = avcodec_open2(cc, enc, nullptr);
  if (rc < 0) {
    set_error(res, "avcodec_open2(enc)", rc);
    cleanup();
    return res;
  }
  avcodec_parameters_from_context(st->codecpar, cc);
  st->time_base = cc->time_base;
  if (title && *title) av_dict_set(&fmt->metadata, "title", title, 0);
  if (artist && *artist) av_dict_set(&fmt->metadata, "artist", artist, 0);

  uint8_t* iobuf = static_cast<uint8_t*>(av_malloc(kIoBuf));
  avio = avio_alloc_context(iobuf, kIoBuf, 1, &mw, nullptr, mem_write, memw_seek);
  fmt->pb = avio;
  fmt->flags |= AVFMT_FLAG_CUSTOM_IO;
  rc = avformat_write_header(fmt, nullptr);
  if (rc < 0) {
    set_error(res, "avformat_write_header", rc);
    cleanup();
    return res;
  }

  pkt = av_packet_alloc();
  frm = av_frame_alloc();
  const int fs = cc->frame_size > 0 ? cc->frame_size : 1024;
  const int64_t n_frames_total = n_interleaved / channels;
  int64_t pos = 0, pts = 0;
  bool done = false;
  while (!done) {
    int rc2;
    if (pos < n_frames_total) {
      int ns = static_cast<int>(std::min<int64_t>(fs, n_frames_total - pos));
      frm->nb_samples = ns;
      frm->format = AV_SAMPLE_FMT_FLTP;
      av_channel_layout_copy(&frm->ch_layout, &cc->ch_layout);
      frm->sample_rate = rate;
      av_frame_get_buffer(frm, 0);
      for (int c = 0; c < channels; ++c) {
        float* dst = reinterpret_cast<float*>(frm->extended_data[c]);
        for (int i = 0; i < ns; ++i)
          dst[i] = samples[(pos + i) * channels + c];
      }
      frm->pts = pts;
      pts += ns;
      pos += ns;
      rc2 = avcodec_send_frame(cc, frm);
      av_frame_unref(frm);
    } else {
      rc2 = avcodec_send_frame(cc, nullptr);
      done = true;
    }
    if (rc2 < 0 && rc2 != AVERROR(EAGAIN) && rc2 != AVERROR_EOF) {
      set_error(res, "avcodec_send_frame", rc2);
      cleanup();
      return res;
    }
    while (true) {
      rc2 = avcodec_receive_packet(cc, pkt);
      if (rc2 == AVERROR(EAGAIN) || rc2 == AVERROR_EOF) break;
      if (rc2 < 0) {
        set_error(res, "avcodec_receive_packet", rc2);
        cleanup();
        return res;
      }
      av_packet_rescale_ts(pkt, cc->time_base, st->time_base);
      pkt->stream_index = st->index;
      av_interleaved_write_frame(fmt, pkt);
    }
  }
  av_write_trailer(fmt);
  avio_flush(avio);
  res->bytes = std::move(mw.buf);
  cleanup();
  return res;
}

const char* flo_ingest_error(void* h) {
  auto* r = static_cast<Result*>(h);
  return r->error.empty() ? nullptr : r->error.c_str();
}
int flo_ingest_rate(void* h) { return static_cast<Result*>(h)->rate; }
int flo_ingest_channels(void* h) { return static_cast<Result*>(h)->channels; }
int64_t flo_ingest_nsamples(void* h) {
  return static_cast<int64_t>(static_cast<Result*>(h)->samples.size());
}
void flo_ingest_samples(void* h, float* out) {
  auto* r = static_cast<Result*>(h);
  std::memcpy(out, r->samples.data(), r->samples.size() * sizeof(float));
}
int flo_ingest_ntags(void* h) {
  return static_cast<int>(static_cast<Result*>(h)->tags.size());
}
const char* flo_ingest_tag_key(void* h, int i) {
  return static_cast<Result*>(h)->tags[i].first.c_str();
}
const char* flo_ingest_tag_val(void* h, int i) {
  return static_cast<Result*>(h)->tags[i].second.c_str();
}
int64_t flo_ingest_cover_size(void* h) {
  return static_cast<int64_t>(static_cast<Result*>(h)->cover.size());
}
const char* flo_ingest_cover_mime(void* h) {
  return static_cast<Result*>(h)->cover_mime.c_str();
}
void flo_ingest_cover(void* h, uint8_t* out) {
  auto* r = static_cast<Result*>(h);
  std::memcpy(out, r->cover.data(), r->cover.size());
}
int64_t flo_ingest_bytes_size(void* h) {
  return static_cast<int64_t>(static_cast<Result*>(h)->bytes.size());
}
void flo_ingest_bytes(void* h, uint8_t* out) {
  auto* r = static_cast<Result*>(h);
  std::memcpy(out, r->bytes.data(), r->bytes.size());
}
void flo_ingest_free(void* h) { delete static_cast<Result*>(h); }

}  // extern "C"
