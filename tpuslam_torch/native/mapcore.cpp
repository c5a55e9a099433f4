// Native map-runtime core: observation index + covisibility counting, and
// the PNG row unfilter of the dataset reader (io/png.py).
//
// The reference's map bookkeeping is C++ (KeyFrame::AddMapPoint /
// UpdateConnections src/KeyFrame.cc:388, MapPoint::AddObservation /
// EraseObservation / Replace src/MapPoint.cc) guarded by mutexes.  Here the
// same bookkeeping is a single-threaded native index behind a C ABI
// (ctypes): the engine owns the map between device dispatches, so no locks
// — the native layer exists for speed on the host-side hot loops that
// cannot be expressed as array ops (incremental inverse-observation
// maintenance, covisibility weight counting, redundancy analysis).
//
// Build: g++ -O2 -shared -fPIC -std=c++17 mapcore.cpp -o mapcore.so, at first
// use, into build/tpuslam_torch/ (tpuslam_torch/native/__init__.py).

#include <cstdint>
#include <cstring>
#include <unordered_map>
#include <vector>

namespace {

struct ObsIndex {
  // mp -> (kf -> slot); kept sorted-free, small maps per point
  std::vector<std::unordered_map<int32_t, int32_t>> obs;
  // kf -> count of observations (for cheap stats)
  std::vector<int32_t> kf_counts;

  void ensure_mp(int32_t mp) {
    if (mp >= (int32_t)obs.size()) obs.resize(mp + 1);
  }
  void ensure_kf(int32_t kf) {
    if (kf >= (int32_t)kf_counts.size()) kf_counts.resize(kf + 1, 0);
  }
};

}  // namespace

extern "C" {

void* obs_new() { return new ObsIndex(); }

void obs_free(void* h) { delete static_cast<ObsIndex*>(h); }

// add observation; returns previous slot for (mp, kf) or -1
int32_t obs_add(void* h, int32_t mp, int32_t kf, int32_t slot) {
  auto* ix = static_cast<ObsIndex*>(h);
  ix->ensure_mp(mp);
  ix->ensure_kf(kf);
  auto& m = ix->obs[mp];
  auto it = m.find(kf);
  int32_t prev = -1;
  if (it != m.end()) {
    prev = it->second;
    it->second = slot;
  } else {
    m.emplace(kf, slot);
    ix->kf_counts[kf]++;
  }
  return prev;
}

// erase observation; returns removed slot or -1
int32_t obs_erase(void* h, int32_t mp, int32_t kf) {
  auto* ix = static_cast<ObsIndex*>(h);
  if (mp >= (int32_t)ix->obs.size()) return -1;
  auto& m = ix->obs[mp];
  auto it = m.find(kf);
  if (it == m.end()) return -1;
  int32_t slot = it->second;
  m.erase(it);
  if (kf < (int32_t)ix->kf_counts.size()) ix->kf_counts[kf]--;
  return slot;
}

int32_t obs_count(void* h, int32_t mp) {
  auto* ix = static_cast<ObsIndex*>(h);
  if (mp >= (int32_t)ix->obs.size()) return 0;
  return (int32_t)ix->obs[mp].size();
}

int32_t obs_get(void* h, int32_t mp, int32_t kf) {
  auto* ix = static_cast<ObsIndex*>(h);
  if (mp >= (int32_t)ix->obs.size()) return -1;
  auto& m = ix->obs[mp];
  auto it = m.find(kf);
  return it == m.end() ? -1 : it->second;
}

// write all (kf, slot) pairs of mp into out_kf/out_slot (cap entries);
// returns the number written
int32_t obs_items(void* h, int32_t mp, int32_t* out_kf, int32_t* out_slot,
                  int32_t cap) {
  auto* ix = static_cast<ObsIndex*>(h);
  if (mp >= (int32_t)ix->obs.size()) return 0;
  int32_t n = 0;
  for (auto& kv : ix->obs[mp]) {
    if (n >= cap) break;
    out_kf[n] = kv.first;
    out_slot[n] = kv.second;
    n++;
  }
  return n;
}

// drop every observation of mp; fills out arrays like obs_items
int32_t obs_clear_mp(void* h, int32_t mp, int32_t* out_kf, int32_t* out_slot,
                     int32_t cap) {
  auto* ix = static_cast<ObsIndex*>(h);
  int32_t n = obs_items(h, mp, out_kf, out_slot, cap);
  if (mp < (int32_t)ix->obs.size()) {
    for (auto& kv : ix->obs[mp])
      if (kv.first < (int32_t)ix->kf_counts.size())
        ix->kf_counts[kv.first]--;
    ix->obs[mp].clear();
  }
  return n;
}

// covisibility counting for one keyframe (ref KeyFrame::UpdateConnections):
// for each valid mp in kf_mp_row (length n, -1 = empty), count other KFs
// observing it.  Returns number of distinct other KFs; their ids/weights in
// out arrays (cap entries).
int32_t covis_count(void* h, int32_t kf, const int32_t* kf_mp_row, int32_t n,
                    int32_t* out_kf, int32_t* out_w, int32_t cap) {
  auto* ix = static_cast<ObsIndex*>(h);
  std::unordered_map<int32_t, int32_t> counts;
  counts.reserve(64);
  for (int32_t i = 0; i < n; i++) {
    int32_t mp = kf_mp_row[i];
    if (mp < 0 || mp >= (int32_t)ix->obs.size()) continue;
    for (auto& kv : ix->obs[mp])
      if (kv.first != kf) counts[kv.first]++;
  }
  int32_t m = 0;
  for (auto& kv : counts) {
    if (m >= cap) break;
    out_kf[m] = kv.first;
    out_w[m] = kv.second;
    m++;
  }
  return m;
}

// redundancy analysis for keyframe culling (ref KeyFrameCulling
// LocalMapping.cc:935): for each valid mp of the row, check whether >= 3
// other KFs observe it at octave <= own_octave + 1.  kf_octaves is a flat
// [n_kf_cap x n_slots] octave table (int8).  Returns #redundant.
int32_t redundancy_count(void* h, int32_t kf, const int32_t* kf_mp_row,
                         int32_t n, const int8_t* kf_octaves,
                         int32_t n_slots, int32_t min_obs) {
  auto* ix = static_cast<ObsIndex*>(h);
  int32_t red = 0;
  for (int32_t i = 0; i < n; i++) {
    int32_t mp = kf_mp_row[i];
    if (mp < 0 || mp >= (int32_t)ix->obs.size()) continue;
    int8_t lvl = kf_octaves[(int64_t)kf * n_slots + i];
    int32_t c = 0;
    for (auto& kv : ix->obs[mp]) {
      if (kv.first == kf) continue;
      if (kf_octaves[(int64_t)kv.first * n_slots + kv.second] <= lvl + 1) {
        if (++c >= min_obs) break;
      }
    }
    if (c >= min_obs) red++;
  }
  return red;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Inverted BoW index (ref: KeyFrameDatabase src/KeyFrameDatabase.cc —
// mvInvertedFile word->KF lists :39, shared-word counting :612-660, L1
// scoring via DBoW2 ScoringObject.cpp). This replaces the DBoW2-side
// native structure: the per-query hot loop walks |query words| lists and
// histograms KF hits, which in Python costs a dict op per (word, kf) pair.

namespace {

struct InvIndex {
  std::vector<std::vector<int32_t>> inv;  // word -> KFs containing it
  // kf -> sorted (word, weight) rows of its L1-normalized BoW vector
  std::unordered_map<int32_t, std::vector<std::pair<int32_t, float>>> bow;
};

}  // namespace

extern "C" {

void* inv_new(int32_t n_words) {
  auto* ix = new InvIndex();
  ix->inv.resize(n_words);
  return ix;
}

void inv_free(void* h) { delete static_cast<InvIndex*>(h); }

// add a keyframe's BoW vector: words sorted ascending, unique
void inv_add(void* h, int32_t kf, const int32_t* words, const float* weights,
             int32_t n) {
  auto* ix = static_cast<InvIndex*>(h);
  auto& row = ix->bow[kf];
  row.clear();
  row.reserve(n);
  for (int32_t i = 0; i < n; i++) {
    int32_t w = words[i];
    if (w < 0 || w >= (int32_t)ix->inv.size()) continue;
    row.emplace_back(w, weights[i]);
    ix->inv[w].push_back(kf);
  }
}

int32_t inv_erase(void* h, int32_t kf) {
  auto* ix = static_cast<InvIndex*>(h);
  auto it = ix->bow.find(kf);
  if (it == ix->bow.end()) return 0;
  for (auto& wv : it->second) {
    auto& lst = ix->inv[wv.first];
    for (size_t i = 0; i < lst.size(); i++) {
      if (lst[i] == kf) {
        lst[i] = lst.back();
        lst.pop_back();
        break;
      }
    }
  }
  ix->bow.erase(it);
  return 1;
}

// shared-word histogram over the inverted file with an exclusion set
// (ref: DetectNBestCandidates :620-660). exclude sorted ascending.
// Returns #distinct KFs written to out_kf/out_count (cap entries).
int32_t inv_shared(void* h, const int32_t* qwords, int32_t nq,
                   const int32_t* exclude, int32_t nx, int32_t* out_kf,
                   int32_t* out_count, int32_t cap) {
  auto* ix = static_cast<InvIndex*>(h);
  std::unordered_map<int32_t, int32_t> counts;
  counts.reserve(128);
  auto excluded = [&](int32_t kf) {
    int32_t lo = 0, hi = nx;
    while (lo < hi) {
      int32_t mid = (lo + hi) / 2;
      if (exclude[mid] < kf) lo = mid + 1;
      else hi = mid;
    }
    return lo < nx && exclude[lo] == kf;
  };
  for (int32_t i = 0; i < nq; i++) {
    int32_t w = qwords[i];
    if (w < 0 || w >= (int32_t)ix->inv.size()) continue;
    for (int32_t kf : ix->inv[w])
      if (!excluded(kf)) counts[kf]++;
  }
  int32_t m = 0;
  for (auto& kv : counts) {
    if (m >= cap) break;
    out_kf[m] = kv.first;
    out_count[m] = kv.second;
    m++;
  }
  return m;
}

// L1 score of the stored KF BoW vs a query (sorted words + weights):
// 0.5 * sum_common(|v|+|u|-|v-u|)  (ref: DBoW2 L1Scoring)
float inv_score(void* h, int32_t kf, const int32_t* qwords, const float* qw,
                int32_t nq) {
  auto* ix = static_cast<InvIndex*>(h);
  auto it = ix->bow.find(kf);
  if (it == ix->bow.end()) return 0.0f;
  const auto& row = it->second;  // sorted by word
  float s = 0.0f;
  size_t a = 0;
  int32_t b = 0;
  while (a < row.size() && b < nq) {
    int32_t wa = row[a].first, wb = qwords[b];
    if (wa == wb) {
      float v = row[a].second, u = qw[b];
      float av = v < 0 ? -v : v, au = u < 0 ? -u : u;
      float d = v - u;
      s += av + au - (d < 0 ? -d : d);
      a++;
      b++;
    } else if (wa < wb) {
      a++;
    } else {
      b++;
    }
  }
  return 0.5f * s;
}

// PNG row unfilter (PNG spec section 9): `src` holds `height` rows of one
// filter-type byte and `stride` filtered bytes; `dst` gets the
// reconstructed [height, stride] bytes. `bpp` is bytes per complete pixel
// (the left neighbour's distance). Average and Paeth depend on the
// reconstructed left byte, so a row is one sequential pass. Returns 0, or
// -(row + 1) for a row with an unknown filter type.
int32_t png_unfilter(const uint8_t* src, uint8_t* dst, int32_t height,
                     int64_t stride, int32_t bpp) {
  for (int32_t r = 0; r < height; r++) {
    const uint8_t* in = src + (int64_t)r * (stride + 1);
    const uint8_t ft = in[0];
    in += 1;
    uint8_t* out = dst + (int64_t)r * stride;
    const uint8_t* up = r > 0 ? out - stride : nullptr;
    for (int64_t i = 0; i < stride; i++) {
      const int a = i >= bpp ? out[i - bpp] : 0;
      const int b = up ? up[i] : 0;
      const int c = (up && i >= bpp) ? up[i - bpp] : 0;
      int pred;
      switch (ft) {
        case 0: pred = 0; break;
        case 1: pred = a; break;
        case 2: pred = b; break;
        case 3: pred = (a + b) >> 1; break;
        case 4: {
          const int p = a + b - c;
          const int pa = p > a ? p - a : a - p;
          const int pb = p > b ? p - b : b - p;
          const int pc = p > c ? p - c : c - p;
          pred = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
          break;
        }
        default: return -(r + 1);
      }
      out[i] = (uint8_t)(in[i] + pred);
    }
  }
  return 0;
}

}  // extern "C"
