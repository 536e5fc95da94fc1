// Native .svati scene parser — the C++ re-implementation of L1.
//
// The reference's L1 is native code on both trees (cpu/parser.c +
// cpu/parse_obj.c + cpu/stack.c in C99; gpu/parser.cpp + gpu/parse_obj.cpp in
// C++17 with std::stack). This is the same layer for the TPU framework: a
// single-pass tokenizer that produces the flat SoA arrays the Python side
// wraps as a Scene pytree. Semantics are identical to
// raytracing_gpu_tpu/models/parser.py (the definitional implementation):
//
// - whitespace token stream, `#` comment-to-end-of-line
// - camera w h pos(3) u(3) v(3) fov
// - a_light rgb / d_light rgb dir / p_light rgb pos
// - object N: N = vertex count, body reads until N*2 v/vn lines, material
//   keys Ka/Kd/Ks (vec3) Ns/Ni/Nr/d (scalar) interleave, unknown tokens are
//   errors
// - LIFO reversal: file vertex order is reversed and truncated to 3*(N/3)
//   (cpu/parse_obj.c:82-88 pops stacks)
// - float literals parsed as double then truncated to f32, matching
//   Python's float() -> np.float32 exactly
//
// Exposed via a plain C ABI (ctypes on the Python side; no pybind11).

#include <algorithm>
#include <cctype>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct Tokenizer {
  const char* p;
  const char* end;

  explicit Tokenizer(const std::string& text)
      : p(text.data()), end(text.data() + text.size()) {}

  // next whitespace-delimited token; skips '#' comments to EOL; returns
  // false at EOF
  bool next(std::string* out) {
    for (;;) {
      while (p < end && std::isspace((unsigned char)*p)) ++p;
      if (p >= end) return false;
      const char* start = p;
      while (p < end && !std::isspace((unsigned char)*p)) ++p;
      if (p - start == 1 && *start == '#') {
        while (p < end && *p != '\n') ++p;
        continue;
      }
      out->assign(start, p - start);
      return true;
    }
  }
};

struct ObjectData {
  float ka[3] = {0, 0, 0};
  float kd[3] = {0, 0, 0};
  float ks[3] = {0, 0, 0};
  float ns = 0.0f, ni = 1.0f, nr = 0.0f, d = 1.0f;  // cpu/parse_obj.c:3-20
  std::vector<float> vs;   // flat xyz, file order
  std::vector<float> vns;
};

}  // namespace

extern "C" {

struct RgtScene {
  int32_t ok;
  char error[512];

  int32_t width, height;
  float position[3], u[3], v[3], fov;

  int64_t n_lights;
  int32_t* light_kind;  // 0 ambient, 1 directional, 2 point
  float* light_rgb;     // (L,3)
  float* light_v;       // (L,3)

  int64_t n_objects;
  float* ka;  // (O,3)
  float* kd;
  float* ks;
  float* ns;  // (O,)
  float* ni;
  float* nr;
  float* d;
  int64_t* tri_count;  // (O,)

  int64_t n_triangles;
  float* vertices;  // (T,3,3) object-major, LIFO-reversed
  float* normals;   // (T,3,3)
};

static RgtScene* fail(RgtScene* s, const std::string& msg) {
  s->ok = 0;
  std::snprintf(s->error, sizeof(s->error), "%s", msg.c_str());
  return s;
}

// double-parse then f32 truncate == Python float() -> np.float32
static bool read_floats(Tokenizer& tz, float* out, int k, std::string* tok) {
  for (int i = 0; i < k; ++i) {
    if (!tz.next(tok)) return false;
    char* endp = nullptr;
    double v = std::strtod(tok->c_str(), &endp);
    if (endp == tok->c_str()) return false;
    out[i] = (float)v;
  }
  return true;
}

RgtScene* rgt_parse(const char* text_c, int64_t len) {
  auto* s = new RgtScene();
  std::memset(s, 0, sizeof(RgtScene));
  s->ok = 1;
  std::string text(text_c, (size_t)len);
  Tokenizer tz(text);

  bool have_camera = false;
  std::vector<int32_t> lkind;
  std::vector<float> lrgb, lv;
  std::vector<ObjectData> objects;

  std::string tok;
  while (tz.next(&tok)) {
    if (tok == "camera") {
      float vals[12];
      if (!read_floats(tz, vals, 12, &tok))
        return fail(s, "unexpected EOF while reading numbers");
      s->width = (int32_t)vals[0];
      s->height = (int32_t)vals[1];
      std::memcpy(s->position, vals + 2, 3 * sizeof(float));
      std::memcpy(s->u, vals + 5, 3 * sizeof(float));
      std::memcpy(s->v, vals + 8, 3 * sizeof(float));
      s->fov = vals[11];
      have_camera = true;
    } else if (tok == "a_light" || tok == "d_light" || tok == "p_light") {
      int kind = tok[0] == 'a' ? 0 : (tok[0] == 'd' ? 1 : 2);
      float rgb[3] = {0, 0, 0}, vec[3] = {0, 0, 0};
      if (!read_floats(tz, rgb, 3, &tok))
        return fail(s, "unexpected EOF while reading numbers");
      if (kind != 0 && !read_floats(tz, vec, 3, &tok))
        return fail(s, "unexpected EOF while reading numbers");
      lkind.push_back(kind);
      lrgb.insert(lrgb.end(), rgb, rgb + 3);
      lv.insert(lv.end(), vec, vec + 3);
    } else if (tok == "object") {
      if (!tz.next(&tok)) return fail(s, "unexpected EOF after 'object'");
      long vertex_count = std::strtol(tok.c_str(), nullptr, 10);
      ObjectData obj;
      long cpt = 0;
      while (cpt < vertex_count * 2) {
        if (!tz.next(&tok)) break;  // EOF ends the loop, like fscanf
        float tmp[3];
        if (tok == "Ka") {
          if (!read_floats(tz, obj.ka, 3, &tok)) return fail(s, "EOF in Ka");
        } else if (tok == "Kd") {
          if (!read_floats(tz, obj.kd, 3, &tok)) return fail(s, "EOF in Kd");
        } else if (tok == "Ks") {
          if (!read_floats(tz, obj.ks, 3, &tok)) return fail(s, "EOF in Ks");
        } else if (tok == "Ns") {
          if (!read_floats(tz, &obj.ns, 1, &tok)) return fail(s, "EOF in Ns");
        } else if (tok == "Ni") {
          if (!read_floats(tz, &obj.ni, 1, &tok)) return fail(s, "EOF in Ni");
        } else if (tok == "Nr") {
          if (!read_floats(tz, &obj.nr, 1, &tok)) return fail(s, "EOF in Nr");
        } else if (tok == "d") {
          if (!read_floats(tz, &obj.d, 1, &tok)) return fail(s, "EOF in d");
        } else if (tok == "v") {
          ++cpt;
          if (!read_floats(tz, tmp, 3, &tok)) return fail(s, "EOF in v");
          obj.vs.insert(obj.vs.end(), tmp, tmp + 3);
        } else if (tok == "vn") {
          ++cpt;
          if (!read_floats(tz, tmp, 3, &tok)) return fail(s, "EOF in vn");
          obj.vns.insert(obj.vns.end(), tmp, tmp + 3);
        } else {
          return fail(s, "Error during parsing " + tok);
        }
      }
      objects.push_back(std::move(obj));
    } else {
      return fail(s, "Error during the parsing " + tok);
    }
  }
  if (!have_camera) return fail(s, "scene has no camera");

  // ---- materialize flat arrays
  s->n_lights = (int64_t)lkind.size();
  if (s->n_lights) {
    s->light_kind = new int32_t[lkind.size()];
    std::memcpy(s->light_kind, lkind.data(), lkind.size() * sizeof(int32_t));
    s->light_rgb = new float[lrgb.size()];
    std::memcpy(s->light_rgb, lrgb.data(), lrgb.size() * sizeof(float));
    s->light_v = new float[lv.size()];
    std::memcpy(s->light_v, lv.data(), lv.size() * sizeof(float));
  }

  s->n_objects = (int64_t)objects.size();
  int64_t total_tris = 0;
  if (s->n_objects) {
    s->ka = new float[3 * objects.size()];
    s->kd = new float[3 * objects.size()];
    s->ks = new float[3 * objects.size()];
    s->ns = new float[objects.size()];
    s->ni = new float[objects.size()];
    s->nr = new float[objects.size()];
    s->d = new float[objects.size()];
    s->tri_count = new int64_t[objects.size()];
    for (size_t i = 0; i < objects.size(); ++i) {
      const ObjectData& o = objects[i];
      std::memcpy(s->ka + 3 * i, o.ka, 3 * sizeof(float));
      std::memcpy(s->kd + 3 * i, o.kd, 3 * sizeof(float));
      std::memcpy(s->ks + 3 * i, o.ks, 3 * sizeof(float));
      s->ns[i] = o.ns;
      s->ni[i] = o.ni;
      s->nr[i] = o.nr;
      s->d[i] = o.d;
      int64_t nv = (int64_t)std::min(o.vs.size(), o.vns.size()) / 3;
      s->tri_count[i] = nv / 3;
      total_tris += nv / 3;
    }
  }

  s->n_triangles = total_tris;
  if (total_tris) {
    s->vertices = new float[total_tris * 9];
    s->normals = new float[total_tris * 9];
    int64_t pos = 0;  // triangle write cursor
    for (const ObjectData& o : objects) {
      int64_t nv = (int64_t)std::min(o.vs.size(), o.vns.size()) / 3;
      int64_t ntri = nv / 3;
      // reversed vertex order, truncated to ntri*3 AFTER reversal:
      // reversed[k] = file[nv-1-k], keep k in [0, 3*ntri)
      for (int64_t k = 0; k < ntri * 3; ++k) {
        int64_t src = nv - 1 - k;
        std::memcpy(s->vertices + (pos * 3 + k) * 3, o.vs.data() + src * 3,
                    3 * sizeof(float));
        std::memcpy(s->normals + (pos * 3 + k) * 3, o.vns.data() + src * 3,
                    3 * sizeof(float));
      }
      pos += ntri;
    }
  }
  return s;
}

void rgt_scene_free(RgtScene* s) {
  if (!s) return;
  delete[] s->light_kind;
  delete[] s->light_rgb;
  delete[] s->light_v;
  delete[] s->ka;
  delete[] s->kd;
  delete[] s->ks;
  delete[] s->ns;
  delete[] s->ni;
  delete[] s->nr;
  delete[] s->d;
  delete[] s->tri_count;
  delete[] s->vertices;
  delete[] s->normals;
  delete s;
}

}  // extern "C"
