// Native Wavefront .OBJ geometry parser (a copy of
// rpt_tpu/native/obj_parser.cpp; kept verbatim so both packages load the
// same triangles from the same text).
//
// Host-side counterpart of the Rust renderer's compiled OBJ reader
// (its src/io.rs:27-200): v/vn/f records, 1-based and negative
// indices, `v//vn` forms, fan triangulation of polygons, flat-normal fill
// when a face lacks normal indices, and usemtl run tracking so the caller
// can split material groups exactly like io.rs:83-149. ~20x the Python
// line-loop on megameshes (871k-triangle dragon class).
//
// C ABI via ctypes; the parser allocates its outputs (rpt_obj_free releases).

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <cmath>
#include <string>
#include <vector>

namespace {

struct Cursor {
  const char* p;
  const char* end;
  bool at_end() const { return p >= end; }
};

inline void skip_ws(Cursor& c) {
  while (!c.at_end() && (*c.p == ' ' || *c.p == '\t' || *c.p == '\r')) ++c.p;
}

inline void skip_line(Cursor& c) {
  while (!c.at_end() && *c.p != '\n') ++c.p;
  if (!c.at_end()) ++c.p;
}

inline bool parse_double(Cursor& c, double* out) {
  skip_ws(c);
  char* q = nullptr;
  double v = std::strtod(c.p, &q);
  if (q == c.p) return false;
  c.p = q;
  *out = v;
  return true;
}

// Parse one face vertex token "v", "v/vt", "v//vn", "v/vt/vn".
// Returns false if no token. vn_out = INT64_MIN when absent.
inline bool parse_face_vert(Cursor& c, int64_t* v_out, int64_t* vn_out) {
  skip_ws(c);
  if (c.at_end() || *c.p == '\n') return false;
  char* q = nullptr;
  long long v = std::strtoll(c.p, &q, 10);
  if (q == c.p) return false;
  c.p = q;
  *v_out = v;
  *vn_out = INT64_MIN;
  if (!c.at_end() && *c.p == '/') {
    ++c.p;  // past first '/'; optional vt
    if (!c.at_end() && *c.p != '/') {
      (void)std::strtoll(c.p, &q, 10);
      c.p = q;
    }
    if (!c.at_end() && *c.p == '/') {
      ++c.p;
      long long vn = std::strtoll(c.p, &q, 10);
      if (q != c.p) {
        c.p = q;
        *vn_out = vn;
      }
    }
  }
  return true;
}

inline int64_t resolve(int64_t idx, int64_t n) {
  // 1-based positive, negative = from end (io.rs:160-163)
  return idx > 0 ? idx - 1 : n + idx;
}

}  // namespace

extern "C" {

void rpt_obj_free(void* p) { std::free(p); }

// Parse OBJ text [data, data+len). On success (return 0) the outputs are
// malloc'd buffers owned by the caller:
//   *out_verts: T*9 doubles (triangle vertices, fan-triangulated)
//   *out_norms: T*9 doubles (explicit vn interpolants, or the flat normal
//               when any corner lacked a vn index — matching io.rs:184-199)
//   *out_run:   T   int32   usemtl run index per triangle (0 before any
//               usemtl; a new run starts at each usemtl line whose name
//               differs from the previous one)
//   *out_names: '\n'-joined usemtl names, one per run >= 1 (run 0 = default)
// Returns nonzero on malformed input (out-of-range indices).
int rpt_parse_obj(const char* data, int64_t len, double** out_verts,
                  double** out_norms, int32_t** out_run, char** out_names,
                  int64_t* out_tris, int64_t* out_runs) {
  Cursor c{data, data + len};
  std::vector<double> vx, vn;          // flat xyz lists
  std::vector<double> tv, tn;          // triangle outputs
  std::vector<int32_t> trun;
  std::string names;
  int32_t cur_run = 0;
  int64_t n_runs = 0;
  std::string last_usemtl;
  std::vector<int64_t> fv, fvn;  // scratch per face

  while (!c.at_end()) {
    skip_ws(c);
    if (c.at_end()) break;
    const char* tok = c.p;
    if (*tok == '\n') {
      ++c.p;
      continue;
    }
    if (tok[0] == 'v' && (tok[1] == ' ' || tok[1] == '\t')) {
      c.p += 1;
      double x, y, z;
      if (!parse_double(c, &x) || !parse_double(c, &y) || !parse_double(c, &z))
        return 1;
      vx.push_back(x);
      vx.push_back(y);
      vx.push_back(z);
      skip_line(c);
    } else if (tok[0] == 'v' && tok[1] == 'n' &&
               (tok[2] == ' ' || tok[2] == '\t')) {
      c.p += 2;
      double x, y, z;
      if (!parse_double(c, &x) || !parse_double(c, &y) || !parse_double(c, &z))
        return 1;
      vn.push_back(x);
      vn.push_back(y);
      vn.push_back(z);
      skip_line(c);
    } else if (tok[0] == 'f' && (tok[1] == ' ' || tok[1] == '\t')) {
      c.p += 1;
      fv.clear();
      fvn.clear();
      int64_t v, n;
      while (parse_face_vert(c, &v, &n)) {
        int64_t vi = resolve(v, (int64_t)vx.size() / 3);
        if (vi < 0 || vi * 3 >= (int64_t)vx.size()) return 2;
        fv.push_back(vi);
        if (n == INT64_MIN) {
          fvn.push_back(-1);
        } else {
          int64_t ni = resolve(n, (int64_t)vn.size() / 3);
          if (ni < 0 || ni * 3 >= (int64_t)vn.size()) return 3;
          fvn.push_back(ni);
        }
      }
      skip_line(c);
      // Fan triangulation (io.rs:165-181)
      for (size_t i = 1; i + 1 < fv.size(); ++i) {
        size_t corners[3] = {0, i, i + 1};
        double V[3][3];
        for (int k = 0; k < 3; ++k)
          for (int d = 0; d < 3; ++d) V[k][d] = vx[3 * fv[corners[k]] + d];
        bool have_n = fvn[corners[0]] >= 0 && fvn[corners[1]] >= 0 &&
                      fvn[corners[2]] >= 0;
        for (int k = 0; k < 3; ++k)
          for (int d = 0; d < 3; ++d) tv.push_back(V[k][d]);
        if (have_n) {
          for (int k = 0; k < 3; ++k)
            for (int d = 0; d < 3; ++d)
              tn.push_back(vn[3 * fvn[corners[k]] + d]);
        } else {
          double e1[3], e2[3], fn[3];
          for (int d = 0; d < 3; ++d) {
            e1[d] = V[1][d] - V[0][d];
            e2[d] = V[2][d] - V[0][d];
          }
          fn[0] = e1[1] * e2[2] - e1[2] * e2[1];
          fn[1] = e1[2] * e2[0] - e1[0] * e2[2];
          fn[2] = e1[0] * e2[1] - e1[1] * e2[0];
          double l = std::sqrt(fn[0] * fn[0] + fn[1] * fn[1] + fn[2] * fn[2]);
          if (l > 0)
            for (int d = 0; d < 3; ++d) fn[d] /= l;
          for (int k = 0; k < 3; ++k)
            for (int d = 0; d < 3; ++d) tn.push_back(fn[d]);
        }
        trun.push_back(cur_run);
      }
    } else if (std::strncmp(tok, "usemtl", 6) == 0 &&
               (tok[6] == ' ' || tok[6] == '\t')) {
      c.p += 6;
      skip_ws(c);
      const char* s = c.p;
      while (!c.at_end() && *c.p != '\n' && *c.p != '\r' && *c.p != ' ' &&
             *c.p != '\t')
        ++c.p;
      std::string name(s, c.p - s);
      skip_line(c);
      if (name != last_usemtl) {  // io.rs:142-148 run semantics
        last_usemtl = name;
        if (!names.empty()) names += '\n';
        names += name;
        cur_run = (int32_t)(++n_runs);
      }
    } else {
      skip_line(c);  // vt, comments, o/g/s/mtllib, ...
    }
  }

  int64_t T = (int64_t)trun.size();
  *out_verts = (double*)std::malloc(sizeof(double) * std::max<int64_t>(9 * T, 1));
  *out_norms = (double*)std::malloc(sizeof(double) * std::max<int64_t>(9 * T, 1));
  *out_run = (int32_t*)std::malloc(sizeof(int32_t) * std::max<int64_t>(T, 1));
  *out_names = (char*)std::malloc(names.size() + 1);
  if (!*out_verts || !*out_norms || !*out_run || !*out_names) return 4;
  std::memcpy(*out_verts, tv.data(), sizeof(double) * 9 * T);
  std::memcpy(*out_norms, tn.data(), sizeof(double) * 9 * T);
  std::memcpy(*out_run, trun.data(), sizeof(int32_t) * T);
  std::memcpy(*out_names, names.c_str(), names.size() + 1);
  *out_tris = T;
  *out_runs = n_runs;
  return 0;
}

}  // extern "C"
