// Native runtime core for opensfm_tpu_torch: tracks CSV codec + union-find
// (a copy of the JAX package's tracks_core.cpp, so the port builds its own).
//
// The reference implements its TracksManager and track merging in C++
// (reference: opensfm/src/map/tracks_manager.cc:30-127 readers,
// :419-448 writer; union-find merge semantics in MergeTracksManager).
// Here the hot, object-free parts live in C++ behind a plain C ABI that
// Python loads with ctypes (pybind11 is not available in this image):
//   - tc_parse / tc_fill / tc_serialize: tracks.csv v0/v1/v2 tokenizing and
//     number formatting into columnar arrays (the Python object graph is
//     rebuilt on the Python side from the columns).
//   - uf_components: path-halving union-find over integer edge lists, used
//     by tracking.create_tracks_manager to link pairwise matches into
//     multi-view tracks.
//   - png_unfilter: the PNG row filters' inverse (io.decode_png), whose
//     Average and Paeth filters run left to right along each row.
//
// Build: g++ -O3 -std=c++17 -shared -fPIC (see opensfm_tpu_torch/native/__init__.py).

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <string_view>
#include <unordered_map>
#include <vector>

namespace {

struct Row {
  int32_t shot;
  int32_t track;
  int64_t feat;
  double x, y, s;
  int64_t r, g, b, seg, inst;
};

struct Parsed {
  std::vector<Row> rows;
  std::string shot_buf;   // '\n'-joined unique shot ids, insertion order
  std::string track_buf;  // '\n'-joined unique track ids, insertion order
  int64_t n_shots = 0;
  int64_t n_tracks = 0;
};

int32_t intern(std::unordered_map<std::string, int32_t>& map, std::string& buf,
               int64_t& count, std::string_view name) {
  auto it = map.find(std::string(name));
  if (it != map.end()) {
    return it->second;
  }
  int32_t id = static_cast<int32_t>(count++);
  map.emplace(std::string(name), id);
  if (!buf.empty()) {
    buf.push_back('\n');
  }
  buf.append(name.data(), name.size());
  return id;
}

bool parse_double(std::string_view s, double* out) {
  char tmp[64];
  size_t n = s.size() < sizeof(tmp) - 1 ? s.size() : sizeof(tmp) - 1;
  std::memcpy(tmp, s.data(), n);
  tmp[n] = '\0';
  char* end = nullptr;
  *out = std::strtod(tmp, &end);
  return end != tmp;
}

bool parse_int(std::string_view s, int64_t* out) {
  char tmp[32];
  size_t n = s.size() < sizeof(tmp) - 1 ? s.size() : sizeof(tmp) - 1;
  std::memcpy(tmp, s.data(), n);
  tmp[n] = '\0';
  char* end = nullptr;
  *out = std::strtoll(tmp, &end, 10);
  return end != tmp;
}

}  // namespace

extern "C" {

// ---------------------------------------------------------------------------
// Union-find connected components.
//
// Nodes are 0..n_nodes-1; edge i joins u[i] and v[i].  Writes a dense
// component label (0..k-1, first-seen order by node index) for every node
// into out_labels and returns k.  Returns -1 on invalid input.
long long uf_components(const long long* u, const long long* v,
                        long long n_edges, long long n_nodes,
                        int32_t* out_labels) {
  if (n_nodes < 0 || n_nodes > INT32_MAX || n_edges < 0) {
    return -1;
  }
  std::vector<int32_t> parent(static_cast<size_t>(n_nodes));
  std::vector<int8_t> rank_(static_cast<size_t>(n_nodes), 0);
  for (int64_t i = 0; i < n_nodes; ++i) {
    parent[i] = static_cast<int32_t>(i);
  }
  auto find = [&](int32_t x) {
    while (parent[x] != x) {
      parent[x] = parent[parent[x]];  // path halving
      x = parent[x];
    }
    return x;
  };
  for (int64_t i = 0; i < n_edges; ++i) {
    int64_t a = u[i], b = v[i];
    if (a < 0 || a >= n_nodes || b < 0 || b >= n_nodes) {
      return -1;
    }
    int32_t ra = find(static_cast<int32_t>(a));
    int32_t rb = find(static_cast<int32_t>(b));
    if (ra == rb) {
      continue;
    }
    if (rank_[ra] < rank_[rb]) {
      std::swap(ra, rb);
    }
    parent[rb] = ra;
    if (rank_[ra] == rank_[rb]) {
      ++rank_[ra];
    }
  }
  // Remap roots to dense labels in first-seen node order.
  std::vector<int32_t> root_label(static_cast<size_t>(n_nodes), -1);
  int32_t next = 0;
  for (int64_t i = 0; i < n_nodes; ++i) {
    int32_t root = find(static_cast<int32_t>(i));
    if (root_label[root] < 0) {
      root_label[root] = next++;
    }
    out_labels[i] = root_label[root];
  }
  return next;
}

// ---------------------------------------------------------------------------
// tracks.csv parsing.

void* tc_parse(const char* buf, long long len) {
  auto* p = new (std::nothrow) Parsed();
  if (p == nullptr) {
    return nullptr;
  }
  const char* ptr = buf;
  const char* end = buf + len;
  int version = 0;
  static const char kHeader[] = "OPENSFM_TRACKS_VERSION";
  const size_t kHeaderLen = sizeof(kHeader) - 1;
  if (static_cast<size_t>(len) > kHeaderLen &&
      std::memcmp(ptr, kHeader, kHeaderLen) == 0) {
    const char* nl = static_cast<const char*>(std::memchr(ptr, '\n', end - ptr));
    std::string_view line(ptr, nl ? static_cast<size_t>(nl - ptr)
                               : static_cast<size_t>(end - ptr));
    size_t pos = line.rfind("_v");
    if (pos != std::string_view::npos) {
      int64_t ver = 0;
      if (parse_int(line.substr(pos + 2), &ver)) {
        version = static_cast<int>(ver);
      }
    }
    ptr = nl ? nl + 1 : end;
  }

  std::unordered_map<std::string, int32_t> shot_map, track_map;
  const int need = version == 0 ? 8 : version == 1 ? 9 : 11;
  while (ptr < end) {
    const char* nl = static_cast<const char*>(std::memchr(ptr, '\n', end - ptr));
    const char* line_end = nl ? nl : end;
    std::string_view line(ptr, static_cast<size_t>(line_end - ptr));
    ptr = nl ? nl + 1 : end;
    if (!line.empty() && line.back() == '\r') {
      line.remove_suffix(1);
    }
    if (line.empty()) {
      continue;
    }
    std::string_view f[11];
    int nf = 0;
    size_t start = 0;
    while (nf < 11) {
      size_t tab = line.find('\t', start);
      if (tab == std::string_view::npos) {
        f[nf++] = line.substr(start);
        break;
      }
      f[nf++] = line.substr(start, tab - start);
      start = tab + 1;
    }
    if (nf < need) {
      delete p;
      return nullptr;
    }
    Row row{};
    row.shot = intern(shot_map, p->shot_buf, p->n_shots, f[0]);
    row.track = intern(track_map, p->track_buf, p->n_tracks, f[1]);
    bool ok = parse_int(f[2], &row.feat) && parse_double(f[3], &row.x) &&
              parse_double(f[4], &row.y);
    int k = 5;
    if (version >= 1) {
      ok = ok && parse_double(f[k++], &row.s);
    } else {
      row.s = 0.0;
    }
    ok = ok && parse_int(f[k], &row.r) && parse_int(f[k + 1], &row.g) &&
         parse_int(f[k + 2], &row.b);
    k += 3;
    if (version >= 2) {
      ok = ok && parse_int(f[k], &row.seg) && parse_int(f[k + 1], &row.inst);
    } else {
      row.seg = -1;
      row.inst = -1;
    }
    if (!ok) {
      delete p;
      return nullptr;
    }
    p->rows.push_back(row);
  }
  return p;
}

long long tc_num_rows(void* h) {
  return static_cast<Parsed*>(h)->rows.size();
}

long long tc_num_shots(void* h) {
  return static_cast<Parsed*>(h)->n_shots;
}

long long tc_num_tracks(void* h) {
  return static_cast<Parsed*>(h)->n_tracks;
}

const char* tc_shot_table(void* h, long long* out_len) {
  auto* p = static_cast<Parsed*>(h);
  *out_len = static_cast<long long>(p->shot_buf.size());
  return p->shot_buf.data();
}

const char* tc_track_table(void* h, long long* out_len) {
  auto* p = static_cast<Parsed*>(h);
  *out_len = static_cast<long long>(p->track_buf.size());
  return p->track_buf.data();
}

// Column fill: xys is [n,3] (x, y, scale); rgb is [n,3]; seg_inst is [n,2].
void tc_fill(void* h, int32_t* shot_idx, int32_t* track_idx, int64_t* feat_id,
             double* xys, int64_t* rgb, int64_t* seg_inst) {
  auto* p = static_cast<Parsed*>(h);
  const size_t n = p->rows.size();
  for (size_t i = 0; i < n; ++i) {
    const Row& r = p->rows[i];
    shot_idx[i] = r.shot;
    track_idx[i] = r.track;
    feat_id[i] = r.feat;
    xys[3 * i + 0] = r.x;
    xys[3 * i + 1] = r.y;
    xys[3 * i + 2] = r.s;
    rgb[3 * i + 0] = r.r;
    rgb[3 * i + 1] = r.g;
    rgb[3 * i + 2] = r.b;
    seg_inst[2 * i + 0] = r.seg;
    seg_inst[2 * i + 1] = r.inst;
  }
}

void tc_free(void* h) { delete static_cast<Parsed*>(h); }

// ---------------------------------------------------------------------------
// tracks.csv v2 serialization from columns.
//
// shot_names / track_names are '\0'-separated name tables (n_shots/n_tracks
// entries).  Returns a malloc'd buffer (free with tc_free_buf); *out_len is
// the byte length.  The "%g" formatting matches Python's ":g" used by the
// pure-Python writer, keeping both byte-identical.
char* tc_serialize(const char* shot_names, long long n_shots,
                   const char* track_names, long long n_tracks,
                   const int32_t* shot_idx, const int32_t* track_idx,
                   const int64_t* feat_id, const double* xys,
                   const int64_t* rgb, const int64_t* seg_inst,
                   long long n_rows, long long* out_len) {
  std::vector<std::string_view> shots(static_cast<size_t>(n_shots));
  std::vector<std::string_view> tracks(static_cast<size_t>(n_tracks));
  const char* ptr = shot_names;
  for (int64_t i = 0; i < n_shots; ++i) {
    size_t len = std::strlen(ptr);
    shots[i] = std::string_view(ptr, len);
    ptr += len + 1;
  }
  ptr = track_names;
  for (int64_t i = 0; i < n_tracks; ++i) {
    size_t len = std::strlen(ptr);
    tracks[i] = std::string_view(ptr, len);
    ptr += len + 1;
  }

  std::string out;
  out.reserve(static_cast<size_t>(n_rows) * 64 + 32);
  out.append("OPENSFM_TRACKS_VERSION_v2");
  char num[352];
  for (int64_t i = 0; i < n_rows; ++i) {
    int32_t si = shot_idx[i];
    int32_t ti = track_idx[i];
    if (si < 0 || si >= n_shots || ti < 0 || ti >= n_tracks) {
      return nullptr;
    }
    out.push_back('\n');
    out.append(shots[si].data(), shots[si].size());
    out.push_back('\t');
    out.append(tracks[ti].data(), tracks[ti].size());
    int len = std::snprintf(
        num, sizeof(num),
        "\t%lld\t%g\t%g\t%g\t%lld\t%lld\t%lld\t%lld\t%lld",
        static_cast<long long>(feat_id[i]), xys[3 * i], xys[3 * i + 1],
        xys[3 * i + 2], static_cast<long long>(rgb[3 * i]),
        static_cast<long long>(rgb[3 * i + 1]),
        static_cast<long long>(rgb[3 * i + 2]),
        static_cast<long long>(seg_inst[2 * i]),
        static_cast<long long>(seg_inst[2 * i + 1]));
    out.append(num, static_cast<size_t>(len));
  }
  out.push_back('\n');

  char* buf = static_cast<char*>(std::malloc(out.size()));
  if (buf == nullptr) {
    return nullptr;
  }
  std::memcpy(buf, out.data(), out.size());
  *out_len = static_cast<long long>(out.size());
  return buf;
}

void tc_free_buf(char* buf) { std::free(buf); }

// Undo the PNG row filters: `raw` holds `height` rows of 1 filter byte and
// `stride` bytes of `bpp`-byte pixels; `out` gets the height x stride
// pixel bytes.  Returns 0, or -1 on an unknown filter type.
int png_unfilter(const uint8_t* raw, long long height, long long stride,
                 long long bpp, uint8_t* out) {
  std::vector<uint8_t> zeros(static_cast<size_t>(stride), 0);
  for (long long y = 0; y < height; ++y) {
    const uint8_t* line = raw + y * (stride + 1);
    const uint8_t f = line[0];
    ++line;
    uint8_t* cur = out + y * stride;
    const uint8_t* up = y ? out + (y - 1) * stride : zeros.data();
    for (long long i = 0; i < stride; ++i) {
      const int a = i >= bpp ? cur[i - bpp] : 0;
      const int b = up[i];
      int pred;
      switch (f) {
        case 0: pred = 0; break;
        case 1: pred = a; break;
        case 2: pred = b; break;
        case 3: pred = (a + b) >> 1; break;
        case 4: {
          const int c = i >= bpp ? up[i - bpp] : 0;
          const int p = a + b - c;
          const int pa = std::abs(p - a), pb = std::abs(p - b),
                    pc = std::abs(p - c);
          pred = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
          break;
        }
        default: return -1;
      }
      cur[i] = static_cast<uint8_t>(line[i] + pred);
    }
  }
  return 0;
}

}  // extern "C"
