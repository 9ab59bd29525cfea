// Native host codec layer: H.264/H.265 encode + decode over libavcodec.
//
// Host counterpart of the reference's hardware/GStreamer codec stack:
//   - examples/JetsonEncoder.cpp:22-116  (V4L2 NvVideoEncoder, CBR rate
//     control, profile/level)            -> vs_enc_* below (libx264 with a
//     real VBV/CBR rate controller; the encoder the reference's x264enc
//     GStreamer element wraps, src/RTSPServer.cpp:79-92).
//   - src/RTSPServer.cpp:80              (bitrate heuristic lives in
//     io/sinks.py; this layer *honors* the requested bitrate).
//   - src/GstdManager.cpp:155-180        (compressed-domain passthrough:
//     vs_dec_* + the Annex-B parser let the Python layer relay or decode
//     H.264 without GStreamer).
//
// C ABI only (consumed via ctypes from io/codec.py). Frames are BGR24
// (OpenCV convention, matching the reference's cv::Mat plumbing).

extern "C" {
#include <libavcodec/avcodec.h>
#include <libavformat/avformat.h>
#include <libavutil/imgutils.h>
#include <libavutil/opt.h>
#include <libswscale/swscale.h>
}

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>

namespace {

struct Encoder {
  AVCodecContext *ctx = nullptr;
  SwsContext *sws = nullptr;
  AVFrame *frame = nullptr;
  AVPacket *pkt = nullptr;
  int64_t pts = 0;
  int64_t bytes_out = 0;
  int width = 0, height = 0;
};

struct Decoder {
  AVCodecContext *ctx = nullptr;
  AVCodecParserContext *parser = nullptr;
  SwsContext *sws = nullptr;
  AVFrame *frame = nullptr;
  AVPacket *pkt = nullptr;
  int sws_w = 0, sws_h = 0;
  std::deque<AVFrame *> ready;  // decoded, not yet handed to the caller
  bool eof_sent = false;
};

// Drain every ready packet from `ctx` into `out`, appending. Returns total
// bytes appended, or <0 on error. Sets *is_key if any packet was a keyframe.
int drain_packets(AVCodecContext *ctx, AVPacket *pkt, uint8_t *out,
                  int out_cap, int *is_key, int64_t *bytes_out) {
  int total = 0;
  for (;;) {
    int ret = avcodec_receive_packet(ctx, pkt);
    if (ret == AVERROR(EAGAIN) || ret == AVERROR_EOF) break;
    if (ret < 0) return -2;
    if (total + pkt->size > out_cap) {
      av_packet_unref(pkt);
      return -3;  // caller buffer too small
    }
    std::memcpy(out + total, pkt->data, pkt->size);
    total += pkt->size;
    if (is_key && (pkt->flags & AV_PKT_FLAG_KEY)) *is_key = 1;
    if (bytes_out) *bytes_out += pkt->size;
    av_packet_unref(pkt);
  }
  return total;
}

}  // namespace

extern "C" {

// ---------------------------------------------------------------------------
// Encoder
// ---------------------------------------------------------------------------

namespace {

// codec_name: "libx264" | "libx265" | "mpeg4"... ; bitrate_bps > 0 enables
// CBR-style VBV rate control (JetsonEncoder.cpp:71-84 semantics);
// zerolatency != 0 -> no B-frames / no lookahead (x264enc tune=zerolatency,
// RTSPServer.cpp:85); gop: keyframe interval in frames (<=0 -> fps);
// global_header != 0 -> extradata-style headers (container muxing) instead
// of in-band SPS/PPS at each IDR (streaming).
void *enc_open_impl(int width, int height, double fps, int64_t bitrate_bps,
                    const char *codec_name, int zerolatency, int gop,
                    int global_header) {
  const AVCodec *codec = avcodec_find_encoder_by_name(codec_name);
  if (!codec) return nullptr;
  Encoder *e = new Encoder();
  e->ctx = avcodec_alloc_context3(codec);
  if (!e->ctx) { delete e; return nullptr; }
  e->width = width;
  e->height = height;
  e->ctx->width = width;
  e->ctx->height = height;
  e->ctx->time_base = AVRational{1000, (int)(fps * 1000 + 0.5)};
  e->ctx->framerate = AVRational{(int)(fps * 1000 + 0.5), 1000};
  e->ctx->pix_fmt = AV_PIX_FMT_YUV420P;
  e->ctx->gop_size = gop > 0 ? gop : (int)(fps + 0.5);
  e->ctx->max_b_frames = zerolatency ? 0 : 2;
  e->ctx->thread_count = 2;
  if (bitrate_bps > 0) {
    // VBV-constrained "CBR": cap the instantaneous rate at the target and
    // give the leaky bucket one second of budget — the same contract as the
    // reference's V4L2_MPEG_VIDEO_BITRATE_MODE_CBR (JetsonEncoder.cpp:76-84).
    e->ctx->bit_rate = bitrate_bps;
    e->ctx->rc_max_rate = bitrate_bps;
    e->ctx->rc_buffer_size = (int)bitrate_bps;
  }
  if (codec->id == AV_CODEC_ID_H264 || codec->id == AV_CODEC_ID_HEVC) {
    av_opt_set(e->ctx->priv_data, "preset", "veryfast", 0);
    if (zerolatency)
      av_opt_set(e->ctx->priv_data, "tune", "zerolatency", 0);
    if (bitrate_bps > 0 && codec->id == AV_CODEC_ID_H264)
      av_opt_set(e->ctx->priv_data, "x264-params", "nal-hrd=cbr", 0);
  }
  if (global_header) e->ctx->flags |= AV_CODEC_FLAG_GLOBAL_HEADER;
  if (avcodec_open2(e->ctx, codec, nullptr) < 0) {
    avcodec_free_context(&e->ctx);
    delete e;
    return nullptr;
  }
  e->frame = av_frame_alloc();
  e->frame->format = AV_PIX_FMT_YUV420P;
  e->frame->width = width;
  e->frame->height = height;
  if (av_frame_get_buffer(e->frame, 0) < 0) {
    avcodec_free_context(&e->ctx);
    av_frame_free(&e->frame);
    delete e;
    return nullptr;
  }
  e->pkt = av_packet_alloc();
  e->sws = sws_getContext(width, height, AV_PIX_FMT_BGR24, width, height,
                          AV_PIX_FMT_YUV420P, SWS_BILINEAR, nullptr, nullptr,
                          nullptr);
  return e;
}

}  // namespace

void *vs_enc_open(int width, int height, double fps, int64_t bitrate_bps,
                  const char *codec_name, int zerolatency, int gop) {
  return enc_open_impl(width, height, fps, bitrate_bps, codec_name,
                       zerolatency, gop, /*global_header=*/0);
}

// Encode one BGR24 frame (height*width*3 bytes, row-major). Appends the
// resulting Annex-B bytes (zero or more NAL units; SPS/PPS in-band at each
// IDR) into `out`. `force_key != 0` forces this frame to be an IDR (used
// when a new streaming client joins, RTSPServer.cpp:95 shared-factory
// semantics). Returns byte count (>=0) or <0 on error (-3: out_cap too
// small).
int vs_enc_encode(void *handle, const uint8_t *bgr, int force_key,
                  uint8_t *out, int out_cap, int *is_key) {
  Encoder *e = (Encoder *)handle;
  if (is_key) *is_key = 0;
  if (av_frame_make_writable(e->frame) < 0) return -1;
  const uint8_t *src[1] = {bgr};
  int src_stride[1] = {e->width * 3};
  sws_scale(e->sws, src, src_stride, 0, e->height, e->frame->data,
            e->frame->linesize);
  e->frame->pts = e->pts++;
  e->frame->pict_type = force_key ? AV_PICTURE_TYPE_I : AV_PICTURE_TYPE_NONE;
  if (avcodec_send_frame(e->ctx, e->frame) < 0) return -1;
  return drain_packets(e->ctx, e->pkt, out, out_cap, is_key, &e->bytes_out);
}

namespace {

// Copy a contiguous planar I420 buffer (Y: h*w, U: h/2*w/2, V: h/2*w/2)
// into the encoder's AVFrame, honoring its linesizes.
void copy_i420_to_frame(AVFrame *f, const uint8_t *i420, int w, int h) {
  const uint8_t *y = i420;
  const uint8_t *u = y + (size_t)w * h;
  const uint8_t *v = u + (size_t)(w / 2) * (h / 2);
  for (int r = 0; r < h; ++r)
    std::memcpy(f->data[0] + (size_t)r * f->linesize[0], y + (size_t)r * w, w);
  for (int r = 0; r < h / 2; ++r) {
    std::memcpy(f->data[1] + (size_t)r * f->linesize[1],
                u + (size_t)r * (w / 2), w / 2);
    std::memcpy(f->data[2] + (size_t)r * f->linesize[2],
                v + (size_t)r * (w / 2), w / 2);
  }
}

}  // namespace

// Encode one planar I420 frame (height*width*3/2 bytes: Y then U then V) —
// the device-side bgr_to_i420 epilogue's native sink. No swscale pass: the
// buffer is already in the encoder's pixel format (AV_PIX_FMT_YUV420P, the
// native input of x264 — the same contract as the reference's x264enc /
// NV12M V4L2 plane, src/RTSPServer.cpp:79-92, examples/JetsonEncoder.cpp:43).
// Same return contract as vs_enc_encode.
int vs_enc_encode_yuv(void *handle, const uint8_t *i420, int force_key,
                      uint8_t *out, int out_cap, int *is_key) {
  Encoder *e = (Encoder *)handle;
  if (is_key) *is_key = 0;
  if (av_frame_make_writable(e->frame) < 0) return -1;
  copy_i420_to_frame(e->frame, i420, e->width, e->height);
  e->frame->pts = e->pts++;
  e->frame->pict_type = force_key ? AV_PICTURE_TYPE_I : AV_PICTURE_TYPE_NONE;
  if (avcodec_send_frame(e->ctx, e->frame) < 0) return -1;
  return drain_packets(e->ctx, e->pkt, out, out_cap, is_key, &e->bytes_out);
}

// Drain the encoder at end of stream. Returns bytes written (0 when fully
// drained) or <0 on error. Call repeatedly until it returns 0.
int vs_enc_flush(void *handle, uint8_t *out, int out_cap, int *is_key) {
  Encoder *e = (Encoder *)handle;
  if (is_key) *is_key = 0;
  avcodec_send_frame(e->ctx, nullptr);  // EOF (idempotent)
  return drain_packets(e->ctx, e->pkt, out, out_cap, is_key, &e->bytes_out);
}

int64_t vs_enc_bytes_out(void *handle) {
  return ((Encoder *)handle)->bytes_out;
}

void vs_enc_close(void *handle) {
  Encoder *e = (Encoder *)handle;
  if (!e) return;
  if (e->sws) sws_freeContext(e->sws);
  if (e->frame) av_frame_free(&e->frame);
  if (e->pkt) av_packet_free(&e->pkt);
  if (e->ctx) avcodec_free_context(&e->ctx);
  delete e;
}

// ---------------------------------------------------------------------------
// Decoder (Annex-B byte stream in, BGR24 frames out)
// ---------------------------------------------------------------------------

void *vs_dec_open(const char *codec_name) {
  const AVCodec *codec =
      std::strcmp(codec_name, "h264") == 0
          ? avcodec_find_decoder(AV_CODEC_ID_H264)
          : (std::strcmp(codec_name, "hevc") == 0
                 ? avcodec_find_decoder(AV_CODEC_ID_HEVC)
                 : avcodec_find_decoder_by_name(codec_name));
  if (!codec) return nullptr;
  Decoder *d = new Decoder();
  d->ctx = avcodec_alloc_context3(codec);
  d->parser = av_parser_init(codec->id);
  if (!d->ctx || !d->parser || avcodec_open2(d->ctx, codec, nullptr) < 0) {
    if (d->parser) av_parser_close(d->parser);
    if (d->ctx) avcodec_free_context(&d->ctx);
    delete d;
    return nullptr;
  }
  d->frame = av_frame_alloc();
  d->pkt = av_packet_alloc();
  return d;
}

namespace {

// Move every frame the codec has ready onto the Decoder's queue.
int queue_ready_frames(Decoder *d) {
  for (;;) {
    int ret = avcodec_receive_frame(d->ctx, d->frame);
    if (ret == AVERROR(EAGAIN) || ret == AVERROR_EOF) return 0;
    if (ret < 0) return -1;
    d->ready.push_back(av_frame_clone(d->frame));
    av_frame_unref(d->frame);
  }
}

}  // namespace

// Feed `size` bytes of Annex-B stream; the whole input is always consumed
// and decoded frames queue internally. `eof != 0` drains the parser +
// codec (end of stream). If a frame is queued, the OLDEST one is converted
// to BGR24 into `bgr_out` (capacity `cap`), *out_w/*out_h set. Returns:
//   1  a frame was written (call again with size=0 to pull the next)
//   0  no frame available
//  -1  decode error      -3  bgr_out too small
int vs_dec_decode(void *handle, const uint8_t *data, int size, int eof,
                  uint8_t *bgr_out, int64_t cap, int *out_w, int *out_h) {
  Decoder *d = (Decoder *)handle;

  const uint8_t *p = data;
  int remaining = size;
  while (remaining > 0 || (eof && !d->eof_sent)) {
    uint8_t *pkt_data = nullptr;
    int pkt_size = 0;
    int used = av_parser_parse2(d->parser, d->ctx, &pkt_data, &pkt_size, p,
                                remaining, AV_NOPTS_VALUE, AV_NOPTS_VALUE, 0);
    if (used < 0) return -1;
    p += used;
    remaining -= used;
    if (pkt_size > 0) {
      d->pkt->data = pkt_data;
      d->pkt->size = pkt_size;
      // A failed send (mid-stream join before the first IDR, bit errors)
      // is recoverable: drop the packet and resynchronize at the next
      // keyframe, as any streaming client does.
      if (avcodec_send_packet(d->ctx, d->pkt) >= 0) {
        if (queue_ready_frames(d) < 0) return -1;
      }
    } else if (remaining <= 0 && eof) {
      avcodec_send_packet(d->ctx, nullptr);  // EOF -> drain codec
      d->eof_sent = true;
      if (queue_ready_frames(d) < 0) return -1;
      break;
    }
    if (remaining <= 0) break;
  }
  if (d->eof_sent) queue_ready_frames(d);

  if (d->ready.empty()) return 0;
  AVFrame *f = d->ready.front();
  int w = f->width, h = f->height;
  if ((int64_t)w * h * 3 > cap) return -3;
  if (!d->sws || d->sws_w != w || d->sws_h != h) {
    if (d->sws) sws_freeContext(d->sws);
    d->sws = sws_getContext(w, h, (AVPixelFormat)f->format, w, h,
                            AV_PIX_FMT_BGR24, SWS_BILINEAR, nullptr, nullptr,
                            nullptr);
    d->sws_w = w;
    d->sws_h = h;
  }
  uint8_t *dst[1] = {bgr_out};
  int dst_stride[1] = {w * 3};
  sws_scale(d->sws, f->data, f->linesize, 0, h, dst, dst_stride);
  *out_w = w;
  *out_h = h;
  d->ready.pop_front();
  av_frame_free(&f);
  return 1;
}

void vs_dec_close(void *handle) {
  Decoder *d = (Decoder *)handle;
  if (!d) return;
  for (AVFrame *f : d->ready) av_frame_free(&f);
  if (d->sws) sws_freeContext(d->sws);
  if (d->parser) av_parser_close(d->parser);
  if (d->frame) av_frame_free(&d->frame);
  if (d->pkt) av_packet_free(&d->pkt);
  if (d->ctx) avcodec_free_context(&d->ctx);
  delete d;
}

// ---------------------------------------------------------------------------
// Container writer: H.264 (or HEVC) encoded + muxed into MP4/MKV via
// libavformat — the proper-container half of the JetsonEncoder role (the
// reference muxes via GStreamer's mp4mux/rtsp pipelines).
// ---------------------------------------------------------------------------

struct Muxer {
  AVFormatContext *fmt = nullptr;
  AVStream *stream = nullptr;
  Encoder *enc = nullptr;     // owns encode side (reuses vs_enc_* plumbing)
  int64_t frames = 0;
};

// Open `path` (container inferred from extension: .mp4, .mkv, .mov) with an
// internal encoder (same knobs as vs_enc_open).
void *vs_mux_open(const char *path, int width, int height, double fps,
                  int64_t bitrate_bps, const char *codec_name,
                  int zerolatency, int gop) {
  Muxer *m = new Muxer();
  m->enc = (Encoder *)enc_open_impl(width, height, fps, bitrate_bps,
                                    codec_name, zerolatency, gop,
                                    /*global_header=*/1);
  if (!m->enc) { delete m; return nullptr; }
  // Containers want extradata (avcC) rather than in-band-only headers;
  // libx264 still emits in-band SPS/PPS without GLOBAL_HEADER, which mp4
  // muxing tolerates via the bitstream filterless hvc1/avc1 path — but be
  // explicit and copy codec parameters after open.
  if (avformat_alloc_output_context2(&m->fmt, nullptr, nullptr, path) < 0 ||
      !m->fmt) {
    vs_enc_close(m->enc);
    delete m;
    return nullptr;
  }
  m->stream = avformat_new_stream(m->fmt, nullptr);
  if (!m->stream ||
      avcodec_parameters_from_context(m->stream->codecpar, m->enc->ctx) < 0) {
    avformat_free_context(m->fmt);
    vs_enc_close(m->enc);
    delete m;
    return nullptr;
  }
  m->stream->time_base = m->enc->ctx->time_base;
  if (!(m->fmt->oformat->flags & AVFMT_NOFILE) &&
      avio_open(&m->fmt->pb, path, AVIO_FLAG_WRITE) < 0) {
    avformat_free_context(m->fmt);
    vs_enc_close(m->enc);
    delete m;
    return nullptr;
  }
  if (avformat_write_header(m->fmt, nullptr) < 0) {
    if (m->fmt->pb) avio_closep(&m->fmt->pb);
    avformat_free_context(m->fmt);
    vs_enc_close(m->enc);
    delete m;
    return nullptr;
  }
  return m;
}

namespace {

int mux_drain(Muxer *m, bool eof) {
  Encoder *e = m->enc;
  if (eof) avcodec_send_frame(e->ctx, nullptr);
  for (;;) {
    int ret = avcodec_receive_packet(e->ctx, e->pkt);
    if (ret == AVERROR(EAGAIN) || ret == AVERROR_EOF) return 0;
    if (ret < 0) return -2;
    e->bytes_out += e->pkt->size;
    av_packet_rescale_ts(e->pkt, e->ctx->time_base, m->stream->time_base);
    e->pkt->stream_index = m->stream->index;
    if (av_interleaved_write_frame(m->fmt, e->pkt) < 0) return -3;
  }
}

}  // namespace

// Encode + mux one BGR24 frame. Returns 0 on success.
int vs_mux_write(void *handle, const uint8_t *bgr) {
  Muxer *m = (Muxer *)handle;
  Encoder *e = m->enc;
  if (av_frame_make_writable(e->frame) < 0) return -1;
  const uint8_t *src[1] = {bgr};
  int src_stride[1] = {e->width * 3};
  sws_scale(e->sws, src, src_stride, 0, e->height, e->frame->data,
            e->frame->linesize);
  e->frame->pts = e->pts++;
  e->frame->pict_type = AV_PICTURE_TYPE_NONE;
  if (avcodec_send_frame(e->ctx, e->frame) < 0) return -1;
  m->frames++;
  return mux_drain(m, false);
}

// Encode + mux one planar I420 frame (no swscale; see vs_enc_encode_yuv).
int vs_mux_write_yuv(void *handle, const uint8_t *i420) {
  Muxer *m = (Muxer *)handle;
  Encoder *e = m->enc;
  if (av_frame_make_writable(e->frame) < 0) return -1;
  copy_i420_to_frame(e->frame, i420, e->width, e->height);
  e->frame->pts = e->pts++;
  e->frame->pict_type = AV_PICTURE_TYPE_NONE;
  if (avcodec_send_frame(e->ctx, e->frame) < 0) return -1;
  m->frames++;
  return mux_drain(m, false);
}

int64_t vs_mux_bytes_out(void *handle) {
  return ((Muxer *)handle)->enc->bytes_out;
}

// Flush encoder, write trailer, close file. Returns 0 on success.
int vs_mux_close(void *handle) {
  Muxer *m = (Muxer *)handle;
  if (!m) return 0;
  int rc = mux_drain(m, true);
  if (av_write_trailer(m->fmt) < 0 && rc == 0) rc = -4;
  if (m->fmt->pb) avio_closep(&m->fmt->pb);
  avformat_free_context(m->fmt);
  vs_enc_close(m->enc);
  delete m;
  return rc;
}

// ---------------------------------------------------------------------------
// Packet remuxer: pre-encoded Annex-B H.264/HEVC access units -> MP4/MKV,
// NO re-encode — the missing half of compressed-domain passthrough into
// container outputs (the reference's qtmux stage). movenc accepts Annex-B
// input (it length-prefixes NALs internally) when extradata carries the
// parameter sets.
// ---------------------------------------------------------------------------

struct PacketMuxer {
  AVFormatContext *fmt = nullptr;
  AVStream *stream = nullptr;
  AVPacket *pkt = nullptr;
  int64_t pts = 0;
  AVRational tb{};
};

// extradata: Annex-B SPS+PPS (+VPS for hevc) from the stream's first AU.
void *vs_muxp_open(const char *path, int width, int height, double fps,
                   const char *codec_name, const uint8_t *extradata,
                   int extradata_size) {
  PacketMuxer *m = new PacketMuxer();
  if (avformat_alloc_output_context2(&m->fmt, nullptr, nullptr, path) < 0 ||
      !m->fmt) {
    delete m;
    return nullptr;
  }
  m->stream = avformat_new_stream(m->fmt, nullptr);
  if (!m->stream) {
    avformat_free_context(m->fmt);
    delete m;
    return nullptr;
  }
  AVCodecParameters *par = m->stream->codecpar;
  par->codec_type = AVMEDIA_TYPE_VIDEO;
  par->codec_id = std::strcmp(codec_name, "hevc") == 0 ||
                          std::strcmp(codec_name, "h265") == 0
                      ? AV_CODEC_ID_HEVC
                      : AV_CODEC_ID_H264;
  par->width = width;
  par->height = height;
  if (extradata && extradata_size > 0) {
    par->extradata = (uint8_t *)av_mallocz(extradata_size +
                                           AV_INPUT_BUFFER_PADDING_SIZE);
    std::memcpy(par->extradata, extradata, extradata_size);
    par->extradata_size = extradata_size;
  }
  m->tb = AVRational{1000, (int)(fps * 1000 + 0.5)};
  m->stream->time_base = m->tb;
  if (!(m->fmt->oformat->flags & AVFMT_NOFILE) &&
      avio_open(&m->fmt->pb, path, AVIO_FLAG_WRITE) < 0) {
    avformat_free_context(m->fmt);
    delete m;
    return nullptr;
  }
  if (avformat_write_header(m->fmt, nullptr) < 0) {
    if (m->fmt->pb) avio_closep(&m->fmt->pb);
    avformat_free_context(m->fmt);
    delete m;
    return nullptr;
  }
  m->pkt = av_packet_alloc();
  return m;
}

// Write one Annex-B access unit. pts_s/dts_s: presentation/decode time in
// SECONDS (pass <= -1e17 for "none": the muxer then stamps a 1/fps
// decode-order counter — correct only for B-frame-free streams).
// Returns 0 on success.
static int muxp_write_impl(PacketMuxer *m, const uint8_t *data, int size,
                           int is_key, double pts_s, double dts_s) {
  // av_packet_from_data REQUIRES AV_INPUT_BUFFER_PADDING_SIZE of
  // zeroed slack past the payload (movenc's NAL parsing reads into it).
  uint8_t *buf =
      (uint8_t *)av_malloc(size + AV_INPUT_BUFFER_PADDING_SIZE);
  if (!buf) return -1;
  std::memcpy(buf, data, size);
  std::memset(buf + size, 0, AV_INPUT_BUFFER_PADDING_SIZE);
  if (av_packet_from_data(m->pkt, buf, size) < 0) {
    av_free(buf);
    return -1;
  }
  if (pts_s > -1e17) {
    // Container timestamps (e.g. from the demuxer) — preserves
    // presentation order for B-frame streams.
    AVRational us{1, 1000000};
    double d = dts_s > -1e17 ? dts_s : pts_s;
    m->pkt->pts = av_rescale_q((int64_t)llround(pts_s * 1e6), us,
                               m->stream->time_base);
    m->pkt->dts = av_rescale_q((int64_t)llround(d * 1e6), us,
                               m->stream->time_base);
    m->pts++;
  } else {
    m->pkt->pts = m->pkt->dts = m->pts++;
    av_packet_rescale_ts(m->pkt, m->tb, m->stream->time_base);
  }
  m->pkt->stream_index = m->stream->index;
  if (is_key) m->pkt->flags |= AV_PKT_FLAG_KEY;
  int rc = av_interleaved_write_frame(m->fmt, m->pkt);
  av_packet_unref(m->pkt);
  return rc < 0 ? -2 : 0;
}

int vs_muxp_write(void *handle, const uint8_t *data, int size, int is_key) {
  return muxp_write_impl((PacketMuxer *)handle, data, size, is_key, -1e18,
                         -1e18);
}

int vs_muxp_write_ts(void *handle, const uint8_t *data, int size,
                     int is_key, double pts_s, double dts_s) {
  return muxp_write_impl((PacketMuxer *)handle, data, size, is_key, pts_s,
                         dts_s);
}

int vs_muxp_close(void *handle) {
  PacketMuxer *m = (PacketMuxer *)handle;
  if (!m) return 0;
  int rc = av_write_trailer(m->fmt) < 0 ? -3 : 0;
  if (m->fmt->pb) avio_closep(&m->fmt->pb);
  if (m->pkt) av_packet_free(&m->pkt);
  avformat_free_context(m->fmt);
  delete m;
  return rc;
}

// ---------------------------------------------------------------------------
// Container demuxer: MP4/MKV/MOV/M4V -> Annex-B H.264/HEVC packets, no
// decode — lets the compressed-domain passthrough ingest the reference's
// container sources (configs name data/long_low.m4v) the way its
// qtdemux->h264parse GStreamer stage does. Packets are emitted in DECODE
// order (what a relay/decoder consumes) with the mp4toannexb bitstream
// filter applied, so the output is a valid Annex-B elementary stream.
// ---------------------------------------------------------------------------

#include <libavcodec/bsf.h>

struct Demuxer {
  AVFormatContext *fmt = nullptr;
  AVBSFContext *bsf = nullptr;
  AVPacket *pkt = nullptr;
  AVPacket *out = nullptr;
  int vstream = -1;
  bool eof = false;
  bool bsf_eof = false;
  bool pending = false;        // oversize packet retained for re-delivery
  double last_pts = -1e18;     // seconds; -1e18 = no timestamp
  double last_dts = -1e18;
  int last_key = 0;
};

// Open a container; returns handle or null. Writes the video codec name
// ("h264"/"hevc"/...) into codec_name_out (cap bytes).
void *vs_demux_open(const char *path, char *codec_name_out, int cap) {
  Demuxer *d = new Demuxer();
  if (avformat_open_input(&d->fmt, path, nullptr, nullptr) < 0) {
    delete d;
    return nullptr;
  }
  if (avformat_find_stream_info(d->fmt, nullptr) < 0) {
    avformat_close_input(&d->fmt);
    delete d;
    return nullptr;
  }
  d->vstream = av_find_best_stream(d->fmt, AVMEDIA_TYPE_VIDEO, -1, -1,
                                   nullptr, 0);
  if (d->vstream < 0) {
    avformat_close_input(&d->fmt);
    delete d;
    return nullptr;
  }
  AVCodecParameters *par = d->fmt->streams[d->vstream]->codecpar;
  const char *name = avcodec_get_name(par->codec_id);
  if (codec_name_out && cap > 0) {
    std::snprintf(codec_name_out, cap, "%s", name ? name : "");
  }
  const char *bsf_name =
      par->codec_id == AV_CODEC_ID_H264   ? "h264_mp4toannexb"
      : par->codec_id == AV_CODEC_ID_HEVC ? "hevc_mp4toannexb"
                                          : nullptr;
  const AVBitStreamFilter *f =
      av_bsf_get_by_name(bsf_name ? bsf_name : "null");
  if (!f || av_bsf_alloc(f, &d->bsf) < 0 ||
      avcodec_parameters_copy(d->bsf->par_in, par) < 0 ||
      av_bsf_init(d->bsf) < 0) {
    if (d->bsf) av_bsf_free(&d->bsf);
    avformat_close_input(&d->fmt);
    delete d;
    return nullptr;
  }
  d->pkt = av_packet_alloc();
  d->out = av_packet_alloc();
  return d;
}

// Deliver the packet held in d->out (timestamps+key stashed, seconds).
// Returns -2 WITHOUT consuming it when cap is too small — the caller can
// retry with a bigger buffer.
static int demux_deliver(Demuxer *d, uint8_t *buf, int cap) {
  int n = d->out->size;
  if (n > cap) {
    d->pending = true;
    return -2;
  }
  std::memcpy(buf, d->out->data, n);
  AVRational tb = d->fmt->streams[d->vstream]->time_base;
  d->last_pts = d->out->pts == AV_NOPTS_VALUE ? -1e18
                                              : d->out->pts * av_q2d(tb);
  d->last_dts = d->out->dts == AV_NOPTS_VALUE ? -1e18
                                              : d->out->dts * av_q2d(tb);
  d->last_key = (d->out->flags & AV_PKT_FLAG_KEY) ? 1 : 0;
  d->pending = false;
  av_packet_unref(d->out);
  return n;
}

// Read the next video packet as Annex-B bytes into buf (cap bytes).
// Returns byte count, 0 at EOF, -1 on error, -2 if cap is too small
// (the packet is RETAINED: call again with a bigger buffer).
int vs_demux_read(void *handle, uint8_t *buf, int cap) {
  Demuxer *d = (Demuxer *)handle;
  if (d->pending) return demux_deliver(d, buf, cap);
  for (;;) {
    int ret = av_bsf_receive_packet(d->bsf, d->out);
    if (ret == 0) {
      return demux_deliver(d, buf, cap);
    }
    if (ret == AVERROR_EOF) return 0;
    if (ret != AVERROR(EAGAIN)) return -1;
    if (d->eof) {
      if (!d->bsf_eof) {
        av_bsf_send_packet(d->bsf, nullptr);
        d->bsf_eof = true;
        continue;
      }
      return 0;
    }
    ret = av_read_frame(d->fmt, d->pkt);
    if (ret < 0) {
      d->eof = true;
      continue;
    }
    if (d->pkt->stream_index != d->vstream) {
      av_packet_unref(d->pkt);
      continue;
    }
    if (av_bsf_send_packet(d->bsf, d->pkt) < 0) {
      av_packet_unref(d->pkt);
      return -1;
    }
    av_packet_unref(d->pkt);
  }
}

// vs_demux_read + the retained packet's timestamps (seconds; <= -1e17 =
// none) and container keyframe flag.
int vs_demux_read2(void *handle, uint8_t *buf, int cap, double *pts_s,
                   double *dts_s, int *is_key) {
  Demuxer *d = (Demuxer *)handle;
  int n = vs_demux_read(handle, buf, cap);
  if (n > 0) {
    if (pts_s) *pts_s = d->last_pts;
    if (dts_s) *dts_s = d->last_dts;
    if (is_key) *is_key = d->last_key;
  }
  return n;
}

void vs_demux_close(void *handle) {
  Demuxer *d = (Demuxer *)handle;
  if (!d) return;
  if (d->bsf) av_bsf_free(&d->bsf);
  if (d->pkt) av_packet_free(&d->pkt);
  if (d->out) av_packet_free(&d->out);
  if (d->fmt) avformat_close_input(&d->fmt);
  delete d;
}

// ---------------------------------------------------------------------------
// Annex-B NAL scanner (compressed-domain passthrough support,
// GstdManager.cpp:155-180 — relay H.264 without decode).
// Returns the number of NAL start positions found (up to max_nals); writes
// byte offsets of each start code into `offsets`.
// ---------------------------------------------------------------------------
int vs_annexb_scan(const uint8_t *data, int64_t size, int64_t *offsets,
                   int max_nals) {
  int n = 0;
  for (int64_t i = 0; i + 3 < size && n < max_nals; ++i) {
    if (data[i] == 0 && data[i + 1] == 0 &&
        (data[i + 2] == 1 ||
         (data[i + 2] == 0 && i + 4 < size && data[i + 3] == 1))) {
      offsets[n++] = i;
      i += 2;
    }
  }
  return n;
}

}  // extern "C"
