// Native data loader for wavtokenizer-tpu.
//
// The reference feeds its GAN trainer from torch DataLoader workers running
// libsndfile/sox (decoder/dataset.py:44-84).  This is the TPU-framework
// equivalent: a C++ thread pool that decodes WAV files, mixes to mono,
// applies sox-style peak normalization, polyphase-sinc resamples (same
// filter design as ops/resample.py so host and device resamplers agree),
// repeat-pads or random-crops to a fixed window, and assembles batches into
// a bounded in-order queue the Python trainer drains via ctypes.
//
// Determinism: every item's gain/crop draws come from a counter-based RNG
// seeded by (seed, epoch, item index), so results are independent of thread
// scheduling — stronger than the reference's worker-dependent streams.
//
// Build: g++ -O3 -march=native -shared -fPIC -std=c++17 -pthread
//        wt_data_loader.cc -o _libwtdata.so     (see native/__init__.py)

#include <algorithm>
#include <atomic>
#include <cmath>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <map>
#include <mutex>
#include <random>
#include <string>
#include <thread>
#include <vector>

namespace {

// ---------------------------------------------------------------------------
// WAV decoding (RIFF/WAVE: PCM 8/16/24/32, IEEE float32/64, extensible)
// ---------------------------------------------------------------------------

struct Wav {
  std::vector<float> mono;  // downmixed
  int sample_rate = 0;
};

uint32_t rd_u32(const uint8_t* p) {
  return (uint32_t)p[0] | ((uint32_t)p[1] << 8) | ((uint32_t)p[2] << 16) |
         ((uint32_t)p[3] << 24);
}
uint16_t rd_u16(const uint8_t* p) {
  return (uint16_t)p[0] | ((uint16_t)p[1] << 8);
}

bool decode_wav(const std::string& path, Wav* out) {
  FILE* f = fopen(path.c_str(), "rb");
  if (!f) return false;
  fseek(f, 0, SEEK_END);
  long size = ftell(f);
  fseek(f, 0, SEEK_SET);
  if (size < 44) { fclose(f); return false; }
  std::vector<uint8_t> buf((size_t)size);
  if (fread(buf.data(), 1, (size_t)size, f) != (size_t)size) {
    fclose(f);
    return false;
  }
  fclose(f);

  if (memcmp(buf.data(), "RIFF", 4) || memcmp(buf.data() + 8, "WAVE", 4))
    return false;

  uint16_t fmt = 0, channels = 0, bits = 0;
  uint32_t sr = 0;
  const uint8_t* data = nullptr;
  uint32_t data_len = 0;

  size_t pos = 12;
  while (pos + 8 <= buf.size()) {
    const uint8_t* ck = buf.data() + pos;
    uint32_t len = rd_u32(ck + 4);
    const uint8_t* body = ck + 8;
    if (pos + 8 + len > buf.size()) len = (uint32_t)(buf.size() - pos - 8);
    if (!memcmp(ck, "fmt ", 4) && len >= 16) {
      fmt = rd_u16(body);
      channels = rd_u16(body + 2);
      sr = rd_u32(body + 4);
      bits = rd_u16(body + 14);
      if (fmt == 0xFFFE && len >= 40) fmt = rd_u16(body + 24);  // extensible
    } else if (!memcmp(ck, "data", 4)) {
      data = body;
      data_len = len;
    }
    pos += 8 + len + (len & 1);  // chunks are word-aligned
  }
  if (!data || !channels || !sr) return false;

  size_t bytes_per = bits / 8;
  if (!bytes_per) return false;
  size_t n_frames = data_len / (bytes_per * channels);
  out->sample_rate = (int)sr;
  out->mono.resize(n_frames);

  auto sample_at = [&](size_t i, int c) -> float {
    const uint8_t* p = data + (i * channels + c) * bytes_per;
    if (fmt == 3) {  // IEEE float
      if (bits == 32) { float v; memcpy(&v, p, 4); return v; }
      if (bits == 64) { double v; memcpy(&v, p, 8); return (float)v; }
      return 0.f;
    }
    switch (bits) {  // PCM
      case 8:  return ((float)p[0] - 128.0f) / 128.0f;
      case 16: return (float)(int16_t)rd_u16(p) / 32768.0f;
      case 24: {
        int32_t v = (int32_t)((uint32_t)p[0] << 8 | (uint32_t)p[1] << 16 |
                              (uint32_t)p[2] << 24) >> 8;
        return (float)v / 8388608.0f;
      }
      case 32: return (float)(int32_t)rd_u32(p) / 2147483648.0f;
      default: return 0.f;
    }
  };

  for (size_t i = 0; i < n_frames; ++i) {
    float acc = 0.f;
    for (int c = 0; c < channels; ++c) acc += sample_at(i, c);
    out->mono[i] = acc / (float)channels;
  }
  return true;
}

// ---------------------------------------------------------------------------
// Polyphase sinc resampler — identical filter design to ops/resample.py
// (torchaudio defaults: lowpass_filter_width=6, rolloff=0.99, hann^2 window)
// ---------------------------------------------------------------------------

struct ResampleKernel {
  std::vector<double> k;  // (new_f, 2*width + orig) row-major
  int width = 0, orig = 1, new_f = 1, klen = 0;
};

ResampleKernel make_kernel(int orig_freq, int new_freq) {
  ResampleKernel rk;
  int g = 1;
  for (int d = std::min(orig_freq, new_freq); d >= 1; --d)
    if (orig_freq % d == 0 && new_freq % d == 0) { g = d; break; }
  rk.orig = orig_freq / g;
  rk.new_f = new_freq / g;
  const int lw = 6;
  const double rolloff = 0.99;
  double base = std::min(rk.orig, rk.new_f) * rolloff;
  rk.width = (int)std::ceil(lw * rk.orig / base);
  rk.klen = 2 * rk.width + rk.orig;
  rk.k.resize((size_t)rk.new_f * rk.klen);
  double scale = base / rk.orig;
  for (int j = 0; j < rk.new_f; ++j) {
    for (int i = 0; i < rk.klen; ++i) {
      double t = ((double)(i - rk.width) / rk.orig - (double)j / rk.new_f) * base;
      t = std::max(-(double)lw, std::min((double)lw, t));
      double win = std::cos(t * M_PI / lw / 2);
      win *= win;
      double tp = t * M_PI;
      double sinc = tp == 0.0 ? 1.0 : std::sin(tp) / tp;
      rk.k[(size_t)j * rk.klen + i] = sinc * win * scale;
    }
  }
  return rk;
}

std::vector<float> resample(const std::vector<float>& x, const ResampleKernel& rk) {
  long L = (long)x.size();
  long padded = L + 2 * rk.width + rk.orig;
  long frames = (padded - rk.klen) / rk.orig + 1;
  long target = (long)std::ceil((double)rk.new_f * L / rk.orig);
  std::vector<float> out((size_t)target, 0.f);
  auto xat = [&](long i) -> double {
    long s = i - rk.width;
    return (s < 0 || s >= L) ? 0.0 : (double)x[(size_t)s];
  };
  for (long t = 0; t < frames; ++t) {
    for (int j = 0; j < rk.new_f; ++j) {
      long oi = t * rk.new_f + j;
      if (oi >= target) break;
      double acc = 0.0;
      const double* kr = rk.k.data() + (size_t)j * rk.klen;
      for (int i = 0; i < rk.klen; ++i) acc += kr[i] * xat(t * rk.orig + i);
      out[(size_t)oi] = (float)acc;
    }
  }
  return out;
}

// ---------------------------------------------------------------------------
// Loader
// ---------------------------------------------------------------------------

struct Loader {
  std::vector<std::string> files;
  int sample_rate, num_samples, batch_size;
  bool train, shuffle, drop_last;
  uint64_t seed;
  int queue_cap;

  std::vector<std::thread> workers;
  std::mutex mu;
  std::condition_variable cv_ready, cv_space;
  std::map<long, std::vector<float>> ready;  // batch_seq -> data
  long next_produce = 0, next_consume = 0;
  std::atomic<bool> stop{false};
  std::atomic<long> errors{0};

  std::mutex kmu;
  std::map<int, ResampleKernel> kernels;  // per source sr

  const ResampleKernel& kernel_for(int sr) {
    std::lock_guard<std::mutex> l(kmu);
    auto it = kernels.find(sr);
    if (it == kernels.end())
      it = kernels.emplace(sr, make_kernel(sr, sample_rate)).first;
    return it->second;
  }

  // Counter-based per-item RNG: independent of thread scheduling.
  std::mt19937_64 item_rng(long epoch, long index) const {
    uint64_t s = seed;
    s = s * 6364136223846793005ULL + (uint64_t)epoch * 1442695040888963407ULL;
    s ^= (uint64_t)index * 0x9E3779B97F4A7C15ULL;
    return std::mt19937_64(s);
  }

  std::vector<long> epoch_order(long epoch) const {
    std::vector<long> order(files.size());
    for (size_t i = 0; i < order.size(); ++i) order[i] = (long)i;
    if (shuffle) {
      std::mt19937_64 r(seed * 0x2545F4914F6CDD1DULL + (uint64_t)epoch);
      std::shuffle(order.begin(), order.end(), r);
    }
    return order;
  }

  long batches_per_epoch() const {
    long n = (long)files.size();
    return drop_last ? n / batch_size : (n + batch_size - 1) / batch_size;
  }

  void load_item(long epoch, long index, float* dst) {
    Wav w;
    if (!decode_wav(files[(size_t)index], &w) || w.mono.empty()) {
      errors++;
      std::memset(dst, 0, sizeof(float) * (size_t)num_samples);
      return;
    }
    auto rng = item_rng(epoch, index);
    // sox `norm <gain>` peak normalization (ref: dataset.py:69-70)
    double gain_db;
    if (train) {
      std::uniform_real_distribution<double> d(-6.0, -1.0);
      gain_db = d(rng);
    } else {
      gain_db = -3.0;
    }
    float peak = 0.f;
    for (float v : w.mono) peak = std::max(peak, std::fabs(v));
    if (peak > 0.f) {
      float s = (float)(std::pow(10.0, gain_db / 20.0) / peak);
      for (float& v : w.mono) v *= s;
    }
    std::vector<float> y = (w.sample_rate == sample_rate)
                               ? std::move(w.mono)
                               : resample(w.mono, kernel_for(w.sample_rate));
    long n = (long)y.size();
    if (n == 0) {
      std::memset(dst, 0, sizeof(float) * (size_t)num_samples);
      return;
    }
    if (n < num_samples) {           // repeat-pad (ref: dataset.py:74-76)
      for (long i = 0; i < num_samples; ++i) dst[i] = y[(size_t)(i % n)];
    } else if (train) {              // random crop (ref: dataset.py:77-79)
      std::uniform_int_distribution<long> d(0, n - num_samples);
      long start = d(rng);
      std::memcpy(dst, y.data() + start, sizeof(float) * (size_t)num_samples);
    } else {                         // head crop (ref: dataset.py:81-83)
      std::memcpy(dst, y.data(), sizeof(float) * (size_t)num_samples);
    }
  }

  void worker() {
    while (!stop.load()) {
      long seq;
      {
        std::unique_lock<std::mutex> l(mu);
        cv_space.wait(l, [&] {
          return stop.load() ||
                 next_produce - next_consume < (long)queue_cap + (long)workers.size();
        });
        if (stop.load()) return;
        seq = next_produce++;
      }
      long bpe = batches_per_epoch();
      long epoch = seq / bpe, b = seq % bpe;
      auto order = epoch_order(epoch);
      std::vector<float> buf((size_t)batch_size * num_samples, 0.f);
      long avail = (long)order.size() - b * batch_size;
      if (avail > batch_size) avail = batch_size;
      for (int i = 0; i < batch_size; ++i) {
        // Tail batch (!drop_last): repeat-pad from the batch's own items so
        // shapes stay static and no row trains as silence (matches the
        // trainer's _pad_batch semantics for the python loader).
        long pos = b * batch_size + (avail > 0 ? i % avail : 0);
        if (pos >= (long)order.size()) break;
        load_item(epoch, order[(size_t)pos], buf.data() + (size_t)i * num_samples);
      }
      {
        std::unique_lock<std::mutex> l(mu);
        ready.emplace(seq, std::move(buf));
        cv_ready.notify_all();
      }
    }
  }

  void start(int n_threads) {
    for (int i = 0; i < n_threads; ++i)
      workers.emplace_back([this] { worker(); });
  }

  int next(float* out) {
    std::unique_lock<std::mutex> l(mu);
    long want = next_consume;
    cv_ready.wait(l, [&] { return stop.load() || ready.count(want); });
    if (stop.load()) return 1;
    auto node = ready.extract(want);
    next_consume++;
    cv_space.notify_all();
    l.unlock();
    std::memcpy(out, node.mapped().data(),
                sizeof(float) * (size_t)batch_size * num_samples);
    return 0;
  }

  ~Loader() {
    stop.store(true);
    cv_ready.notify_all();
    cv_space.notify_all();
    for (auto& t : workers) t.join();
  }
};

}  // namespace

extern "C" {

// start_seq fast-forwards the deterministic batch stream without decoding:
// batch `seq` is a pure function of (seed, seq) — epoch = seq / bpe, order =
// epoch_order(epoch), items seeded by (seed, epoch, index) — so a resumed
// training run positions the loader exactly where the interrupted run
// stopped by passing its global step count here.
void* wtl_create(const char* filelist, int sample_rate, int num_samples,
                 int batch_size, int train, int shuffle, int drop_last,
                 int num_threads, int queue_cap, unsigned long long seed,
                 long long start_seq) {
  auto* L = new Loader();
  const char* p = filelist;
  while (*p) {
    const char* e = strchr(p, '\n');
    size_t len = e ? (size_t)(e - p) : strlen(p);
    if (len) L->files.emplace_back(p, len);
    p += len + (e ? 1 : 0);
  }
  if (L->files.empty() || batch_size <= 0) { delete L; return nullptr; }
  L->sample_rate = sample_rate;
  L->num_samples = num_samples;
  L->batch_size = batch_size;
  L->train = train != 0;
  L->shuffle = shuffle != 0;
  L->drop_last = drop_last != 0;
  L->seed = seed;
  L->queue_cap = queue_cap > 0 ? queue_cap : 4;
  if (start_seq > 0) L->next_produce = L->next_consume = (long)start_seq;
  L->start(num_threads > 0 ? num_threads : 4);
  return L;
}

int wtl_next(void* h, float* out) { return ((Loader*)h)->next(out); }

long wtl_errors(void* h) { return ((Loader*)h)->errors.load(); }

long wtl_num_files(void* h) { return (long)((Loader*)h)->files.size(); }

void wtl_destroy(void* h) { delete (Loader*)h; }

// Single-file decode (mono float32).  Two-phase: call with out=nullptr to get
// the length, then with a buffer of that size.
int wtl_read_wav(const char* path, float* out, long* n, int* sr) {
  Wav w;
  if (!decode_wav(path, &w)) return 1;
  *n = (long)w.mono.size();
  *sr = w.sample_rate;
  if (out) std::memcpy(out, w.mono.data(), sizeof(float) * w.mono.size());
  return 0;
}

// Standalone resample for parity tests.
long wtl_resample(const float* x, long n, int orig_sr, int new_sr, float* out) {
  ResampleKernel rk = make_kernel(orig_sr, new_sr);
  std::vector<float> xin(x, x + n);
  auto y = resample(xin, rk);
  if (out) std::memcpy(out, y.data(), sizeof(float) * y.size());
  return (long)y.size();
}

}  // extern "C"
