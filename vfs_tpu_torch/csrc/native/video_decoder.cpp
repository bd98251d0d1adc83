// Native FFmpeg video decoder for vfs_tpu.
//
// The reference trains Kinetics-400 from .mp4 through decord's C++/FFmpeg
// decode with a unique-index decode map (reference
// mmaction/datasets/pipelines/loading.py:801-880). This is the TPU-host
// equivalent: libavformat/libavcodec demux+decode of exactly the requested
// frame indices into a caller-provided RGB24 batch buffer, with optional
// swscale resize, seeking to the nearest preceding keyframe instead of
// decoding from frame 0. Called via ctypes (GIL released for the whole
// call) from vfs_tpu.datasets.native_loader.
//
// Build: g++ -O3 -shared -fPIC -std=c++17 video_decoder.cpp
//        -lavformat -lavcodec -lavutil -lswscale -o libvideo_decoder.so
//
// vfs_tpu_torch's copy of vfs_tpu/native/video_decoder.cpp, with one change:
// swscale converts into a scratch image with padded rows (see `scratch`),
// so every pixel of a frame is written, whatever its width, and nothing is
// written past the caller's buffer. The frames the original writes whole
// are the same.

#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {
#include <libavcodec/avcodec.h>
#include <libavformat/avformat.h>
#include <libavutil/imgutils.h>
#include <libswscale/swscale.h>
}

namespace {

struct VideoHandle {
  AVFormatContext* fmt = nullptr;
  AVCodecContext* codec = nullptr;
  int stream_index = -1;
  AVStream* stream = nullptr;

  ~VideoHandle() {
    if (codec != nullptr) avcodec_free_context(&codec);
    if (fmt != nullptr) avformat_close_input(&fmt);
  }

  bool open(const char* path) {
    if (avformat_open_input(&fmt, path, nullptr, nullptr) < 0) return false;
    if (avformat_find_stream_info(fmt, nullptr) < 0) return false;
    const AVCodec* dec = nullptr;
    stream_index =
        av_find_best_stream(fmt, AVMEDIA_TYPE_VIDEO, -1, -1, &dec, 0);
    if (stream_index < 0 || dec == nullptr) return false;
    stream = fmt->streams[stream_index];
    codec = avcodec_alloc_context3(dec);
    if (codec == nullptr) return false;
    if (avcodec_parameters_to_context(codec, stream->codecpar) < 0)
      return false;
    codec->thread_count = 0;  // auto
    if (avcodec_open2(codec, dec, nullptr) < 0) return false;
    return true;
  }

  double fps() const {
    AVRational r = stream->avg_frame_rate;
    if (r.num == 0 || r.den == 0) r = stream->r_frame_rate;
    if (r.num == 0 || r.den == 0) return 0.0;
    return av_q2d(r);
  }

  int64_t num_frames() const {
    if (stream->nb_frames > 0) return stream->nb_frames;
    // fall back to duration * fps (some containers omit nb_frames)
    int64_t duration = stream->duration;
    if (duration <= 0 && fmt->duration > 0) {
      return static_cast<int64_t>(fmt->duration / (double)AV_TIME_BASE *
                                  fps());
    }
    if (duration <= 0) return 0;
    return static_cast<int64_t>(duration * av_q2d(stream->time_base) *
                                fps());
  }

  // frame index of a decoded frame from its timestamp (CFR assumption,
  // which holds for the training corpora; NOPTS falls back to -1 and the
  // caller counts sequentially)
  int64_t pts_to_index(int64_t pts) const {
    if (pts == AV_NOPTS_VALUE) return -1;
    int64_t start = stream->start_time == AV_NOPTS_VALUE
                        ? 0
                        : stream->start_time;
    double sec = (pts - start) * av_q2d(stream->time_base);
    return static_cast<int64_t>(sec * fps() + 0.5);
  }

  int64_t index_to_ts(int64_t index) const {
    int64_t start = stream->start_time == AV_NOPTS_VALUE
                        ? 0
                        : stream->start_time;
    double f = fps();
    if (f <= 0.0) return start;
    return start + static_cast<int64_t>(index / f /
                                        av_q2d(stream->time_base));
  }
};

}  // namespace

extern "C" {

// Probe container metadata. Returns 0 on success.
int vd_probe(const char* path, int64_t* num_frames, int* height, int* width,
             double* fps) {
  VideoHandle v;
  if (!v.open(path)) return -1;
  *num_frames = v.num_frames();
  *height = v.codec->height;
  *width = v.codec->width;
  *fps = v.fps();
  return (*num_frames > 0 && *height > 0 && *width > 0) ? 0 : -2;
}

// Decode the frames at `indices` (sorted ascending, unique) into `out`
// as RGB24 (n, out_h, out_w, 3). Missing tail frames (metadata counted
// more frames than exist) repeat the last decoded frame. Returns the
// number of indices filled from real decodes, or <0 on error.
int vd_decode_indices(const char* path, const int64_t* indices, int n,
                      uint8_t* out, int out_h, int out_w) {
  if (n <= 0) return 0;
  VideoHandle v;
  if (!v.open(path)) return -1;

  const size_t frame_bytes = static_cast<size_t>(out_h) * out_w * 3;
  // swscale's SIMD converters work on whole groups of pixels and whole
  // vector stores: into rows of exactly out_w * 3 bytes they may leave the
  // last pixels of a row unwritten or store past its end, past the
  // caller's buffer on the last row (FFmpeg 5.1, unscaled yuv420p ->
  // rgb24 at widths 340, 342 and 344). So they convert into a scratch
  // image with padded, 64-byte aligned rows, and the rows are copied out.
  const int row_bytes = out_w * 3;
  const int pitch = (row_bytes + 16 * 3 + 63) & ~63;
  uint8_t* scratch = static_cast<uint8_t*>(
      av_malloc(static_cast<size_t>(pitch) * (out_h + 1)));
  SwsContext* sws = nullptr;
  AVFrame* frame = av_frame_alloc();
  AVFrame* last_frame = av_frame_alloc();  // newest decoded frame (clamp src)
  AVPacket* pkt = av_packet_alloc();
  if (scratch == nullptr || frame == nullptr || last_frame == nullptr ||
      pkt == nullptr) {
    av_free(scratch);
    av_frame_free(&frame);
    av_frame_free(&last_frame);
    av_packet_free(&pkt);
    return -3;
  }

  // seek to the keyframe at/before the first wanted index; decode forward
  if (indices[0] > 0) {
    int64_t ts = v.index_to_ts(indices[0]);
    if (av_seek_frame(v.fmt, v.stream_index, ts, AVSEEK_FLAG_BACKWARD) >= 0)
      avcodec_flush_buffers(v.codec);
  }

  int want = 0;           // next position in indices[]
  int filled = 0;         // indices satisfied by real decodes
  int64_t seq_index = -1; // sequential counter fallback (no pts)
  bool use_seq = false;
  bool eof = false;

  auto store = [&](const AVFrame* f, int slot) {
    uint8_t* dst = out + static_cast<size_t>(slot) * frame_bytes;
    uint8_t* dst_data[4] = {scratch, nullptr, nullptr, nullptr};
    int dst_linesize[4] = {pitch, 0, 0, 0};
    sws = sws_getCachedContext(
        sws, f->width, f->height,
        static_cast<AVPixelFormat>(f->format), out_w, out_h,
        AV_PIX_FMT_RGB24, SWS_BILINEAR, nullptr, nullptr, nullptr);
    if (sws == nullptr) return false;
    sws_scale(sws, f->data, f->linesize, 0, f->height, dst_data,
              dst_linesize);
    for (int r = 0; r < out_h; ++r) {
      std::memcpy(dst + static_cast<size_t>(r) * row_bytes,
                  scratch + static_cast<size_t>(r) * pitch, row_bytes);
    }
    return true;
  };

  while (want < n && !eof) {
    int ret = av_read_frame(v.fmt, pkt);
    if (ret < 0) {
      // flush the decoder
      avcodec_send_packet(v.codec, nullptr);
      eof = true;
    } else if (pkt->stream_index != v.stream_index) {
      av_packet_unref(pkt);
      continue;
    } else {
      avcodec_send_packet(v.codec, pkt);
      av_packet_unref(pkt);
    }
    while (want < n) {
      ret = avcodec_receive_frame(v.codec, frame);
      if (ret == AVERROR(EAGAIN) || ret == AVERROR_EOF) break;
      if (ret < 0) {
        eof = true;
        break;
      }
      int64_t idx = v.pts_to_index(frame->best_effort_timestamp);
      if (use_seq || idx < 0) {
        // containers without usable pts: count sequentially from the
        // first decoded frame (only correct without seeking, but such
        // containers aren't seekable by timestamp anyway)
        use_seq = true;
        idx = ++seq_index;
      } else {
        seq_index = idx;
      }
      // fill every wanted index at or before the current frame (exact
      // match, or nearest-after frame when timestamps skip in VFR video)
      while (want < n && indices[want] <= idx) {
        if (!store(frame, want)) {
          av_frame_free(&frame);
          av_frame_free(&last_frame);
          av_packet_free(&pkt);
          av_free(scratch);
          if (sws != nullptr) sws_freeContext(sws);
          return -4;
        }
        ++filled;
        ++want;
      }
      // remember the newest decoded frame even when no wanted index
      // matched: if every wanted index lies past the true last frame
      // (duration*fps metadata overcount on VFR video), the tail clamp
      // below still needs real pixels to repeat — decord clamps to the
      // last frame instead of erroring, and so do we.
      av_frame_unref(last_frame);
      av_frame_ref(last_frame, frame);
      av_frame_unref(frame);
    }
  }

  // metadata overcounted: wanted indices remain past the true last
  // frame. Clamp them to the LAST DECODED frame (decord semantics) —
  // not the last *stored* one, which may be an earlier wanted index.
  if (want < n && last_frame->data[0] != nullptr) {
    if (store(last_frame, want)) {
      ++filled;
      ++want;
    }
  }
  if (filled > 0 && want < n) {
    const uint8_t* last = out + static_cast<size_t>(want - 1) * frame_bytes;
    for (int i = want; i < n; ++i) {
      std::memcpy(out + static_cast<size_t>(i) * frame_bytes, last,
                  frame_bytes);
    }
  }

  av_frame_free(&frame);
  av_frame_free(&last_frame);
  av_packet_free(&pkt);
  av_free(scratch);
  if (sws != nullptr) sws_freeContext(sws);
  return filled > 0 ? filled : -5;
}

}  // extern "C"
