// Native regenerating-code plugin: libec_regen_native.so.
//
// C++ twin of the Python product-matrix MSR plugin (plugins/regen.py over
// matrices/product_matrix.py): d = 2k-2, alpha = k-1, every node stores
// alpha sub-chunks and the whole code linearizes to one systematic
// GF(2^8) generator over virtual rows (node i sub-chunk j = virtual row
// i*alpha+j).  Same field polynomial (0x11D), same evaluation-point
// selection and the same generator algebra as the Python construction,
// so chunks encoded here are bit-identical to the Python plugin's.
// Port of ceph_tpu/native/plugin_regen.cpp.

#include "ec_plugin.h"

#include <cstdlib>
#include <cstring>
#include <new>
#include <vector>

namespace {

// -- GF(2^8), poly x^8+x^4+x^3+x^2+1 (0x11D), generator x=2 ------------

struct GF8 {
  uint8_t exp[512];
  uint8_t log[256];
  GF8() {
    unsigned v = 1;
    for (int i = 0; i < 255; ++i) {
      exp[i] = static_cast<uint8_t>(v);
      log[v] = static_cast<uint8_t>(i);
      v <<= 1;
      if (v & 0x100) v ^= 0x11D;
    }
    for (int i = 255; i < 512; ++i) exp[i] = exp[i - 255];
    log[0] = 0;
  }
  uint8_t mul(uint8_t a, uint8_t b) const {
    if (!a || !b) return 0;
    return exp[log[a] + log[b]];
  }
  uint8_t inv(uint8_t a) const { return exp[255 - log[a]]; }
  uint8_t pow(uint8_t x, unsigned e) const {
    if (e == 0) return 1;
    if (x == 0) return 0;
    return exp[(log[x] * (e % 255)) % 255];
  }
};

const GF8 &gf() {
  static const GF8 field;
  return field;
}

using Mat = std::vector<std::vector<uint8_t>>;

Mat mat_mul(const Mat &a, const Mat &b) {
  const GF8 &f = gf();
  size_t n = a.size(), p = b.size(), m = b[0].size();
  Mat out(n, std::vector<uint8_t>(m, 0));
  for (size_t i = 0; i < n; ++i)
    for (size_t t = 0; t < p; ++t) {
      uint8_t c = a[i][t];
      if (!c) continue;
      for (size_t j = 0; j < m; ++j) out[i][j] ^= f.mul(c, b[t][j]);
    }
  return out;
}

// Gauss-Jordan inverse; false when singular
bool mat_invert(Mat m, Mat &out) {
  const GF8 &f = gf();
  size_t n = m.size();
  out.assign(n, std::vector<uint8_t>(n, 0));
  for (size_t i = 0; i < n; ++i) out[i][i] = 1;
  for (size_t col = 0; col < n; ++col) {
    size_t piv = col;
    while (piv < n && m[piv][col] == 0) ++piv;
    if (piv == n) return false;
    std::swap(m[piv], m[col]);
    std::swap(out[piv], out[col]);
    uint8_t d = f.inv(m[col][col]);
    for (size_t j = 0; j < n; ++j) {
      m[col][j] = f.mul(m[col][j], d);
      out[col][j] = f.mul(out[col][j], d);
    }
    for (size_t r = 0; r < n; ++r) {
      if (r == col || m[r][col] == 0) continue;
      uint8_t c = m[r][col];
      for (size_t j = 0; j < n; ++j) {
        m[r][j] ^= f.mul(c, m[col][j]);
        out[r][j] ^= f.mul(c, out[col][j]);
      }
    }
  }
  return true;
}

// -- product-matrix construction (mirrors matrices/product_matrix.py) --

struct Regen {
  int k, m, n, alpha;
  Mat generator;  // (m*alpha, k*alpha)
};

// n evaluation points with pairwise-distinct alpha-th powers, in the
// same iteration order as the Python _select_points
bool select_points(int n, int alpha, std::vector<uint8_t> &lam) {
  const GF8 &f = gf();
  bool seen[256] = {false};
  for (int x = 0; x < 256 && static_cast<int>(lam.size()) < n; ++x) {
    uint8_t p = f.pow(static_cast<uint8_t>(x), alpha);
    if (seen[p]) continue;
    seen[p] = true;
    lam.push_back(static_cast<uint8_t>(x));
  }
  return static_cast<int>(lam.size()) == n;
}

bool build_generator(Regen &rg) {
  const GF8 &f = gf();
  const int k = rg.k, n = rg.n, alpha = rg.alpha, B = k * alpha;
  std::vector<uint8_t> lam;
  if (!select_points(n, alpha, lam)) return false;
  // free-symbol slots: S1 then S2 upper triangles, symmetry folded
  std::vector<std::vector<int>> idx(2 * alpha, std::vector<int>(alpha));
  int slot = 0;
  for (int which = 0; which < 2; ++which)
    for (int i = 0; i < alpha; ++i)
      for (int j = i; j < alpha; ++j) {
        idx[which * alpha + i][j] = slot;
        idx[which * alpha + j][i] = slot;
        ++slot;
      }
  // A_i per node: alpha linear forms over the B free symbols
  Mat a_data(B, std::vector<uint8_t>(B, 0));
  Mat a_parity(rg.m * alpha, std::vector<uint8_t>(B, 0));
  for (int node = 0; node < n; ++node) {
    uint8_t la = f.pow(lam[node], alpha);
    for (int j = 0; j < alpha; ++j) {
      std::vector<uint8_t> &row = node < k ? a_data[node * alpha + j]
                                           : a_parity[(node - k) * alpha + j];
      for (int t = 0; t < alpha; ++t) {
        uint8_t c = f.pow(lam[node], t);  // phi[node][t]
        row[idx[t][j]] ^= c;
        row[idx[alpha + t][j]] ^= f.mul(la, c);
      }
    }
  }
  Mat inv;
  if (!mat_invert(a_data, inv)) return false;
  rg.generator = mat_mul(a_parity, inv);
  return true;
}

// -- vtable ------------------------------------------------------------

int regen_encode(ec_codec *self, const uint8_t *const *data,
                 uint8_t *const *coding, size_t chunk_len) {
  const GF8 &f = gf();
  const Regen *rg = static_cast<const Regen *>(self->priv);
  const int alpha = rg->alpha;
  if (chunk_len % alpha) return -1;  // need whole sub-chunks
  const size_t beta = chunk_len / alpha;
  for (int node = 0; node < rg->m; ++node)
    for (int j = 0; j < alpha; ++j) {
      uint8_t *out = coding[node] + j * beta;
      std::memset(out, 0, beta);
      const std::vector<uint8_t> &grow = rg->generator[node * alpha + j];
      for (int c = 0; c < rg->k * alpha; ++c) {
        uint8_t g = grow[c];
        if (!g) continue;
        const uint8_t *src = data[c / alpha] + (c % alpha) * beta;
        for (size_t b = 0; b < beta; ++b) out[b] ^= f.mul(g, src[b]);
      }
    }
  return 0;
}

int regen_decode(ec_codec *self, uint8_t *const *chunks, const int *erased,
                 size_t chunk_len) {
  const GF8 &f = gf();
  const Regen *rg = static_cast<const Regen *>(self->priv);
  const int k = rg->k, alpha = rg->alpha, kv = k * alpha;
  if (chunk_len % alpha) return -1;
  const size_t beta = chunk_len / alpha;
  bool gone[256] = {false};
  int nerased = 0;
  for (int i = 0; erased[i] != -1; ++i) {
    gone[erased[i]] = true;
    ++nerased;
  }
  if (nerased == 0) return 0;
  // first k whole surviving nodes; their stacked virtual rows are
  // invertible by the MDS property of the linearized code
  std::vector<int> src_nodes;
  for (int i = 0; i < rg->n && static_cast<int>(src_nodes.size()) < k; ++i)
    if (!gone[i]) src_nodes.push_back(i);
  if (static_cast<int>(src_nodes.size()) < k) return -1;
  Mat sel(kv, std::vector<uint8_t>(kv, 0));
  for (int r = 0; r < k; ++r) {
    int node = src_nodes[r];
    for (int j = 0; j < alpha; ++j) {
      if (node < k)
        sel[r * alpha + j][node * alpha + j] = 1;
      else
        sel[r * alpha + j] = rg->generator[(node - k) * alpha + j];
    }
  }
  Mat inv;
  if (!mat_invert(sel, inv)) return -1;
  // data virtual rows = inv @ stacked survivor rows
  std::vector<std::vector<uint8_t>> dvr(
      kv, std::vector<uint8_t>(beta, 0));
  for (int r = 0; r < kv; ++r)
    for (int c = 0; c < kv; ++c) {
      uint8_t g = inv[r][c];
      if (!g) continue;
      const uint8_t *src =
          chunks[src_nodes[c / alpha]] + (c % alpha) * beta;
      for (size_t b = 0; b < beta; ++b) dvr[r][b] ^= f.mul(g, src[b]);
    }
  for (int i = 0; erased[i] != -1; ++i) {
    int node = erased[i];
    for (int j = 0; j < alpha; ++j) {
      uint8_t *out = chunks[node] + j * beta;
      if (node < k) {
        std::memcpy(out, dvr[node * alpha + j].data(), beta);
      } else {
        std::memset(out, 0, beta);
        const std::vector<uint8_t> &grow =
            rg->generator[(node - k) * alpha + j];
        for (int c = 0; c < kv; ++c) {
          uint8_t g = grow[c];
          if (!g) continue;
          for (size_t b = 0; b < beta; ++b)
            out[b] ^= f.mul(g, dvr[c][b]);
        }
      }
    }
  }
  return 0;
}

void regen_destroy(ec_codec *self) {
  delete static_cast<Regen *>(self->priv);
  delete self;
}

ec_codec *regen_factory(const char *const *profile) {
  int k = 4, m = 3, w = 8, d = -1;
  const char *technique = nullptr;
  for (int i = 0; profile && profile[i]; ++i) {
    if (std::strncmp(profile[i], "k=", 2) == 0)
      k = std::atoi(profile[i] + 2);
    else if (std::strncmp(profile[i], "m=", 2) == 0)
      m = std::atoi(profile[i] + 2);
    else if (std::strncmp(profile[i], "w=", 2) == 0)
      w = std::atoi(profile[i] + 2);
    else if (std::strncmp(profile[i], "d=", 2) == 0)
      d = std::atoi(profile[i] + 2);
    else if (std::strncmp(profile[i], "technique=", 10) == 0)
      technique = profile[i] + 10;
  }
  // same validation surface as the Python plugin's -EINVAL parse
  if (w != 8) return nullptr;
  if (k < 2 || m < k - 1) return nullptr;
  if (d != -1 && d != 2 * k - 2) return nullptr;
  if (technique && std::strcmp(technique, "product_matrix") != 0)
    return nullptr;
  Regen *rg = new (std::nothrow) Regen();
  if (!rg) return nullptr;
  rg->k = k;
  rg->m = m;
  rg->n = k + m;
  rg->alpha = k - 1;
  if (!build_generator(*rg)) {
    delete rg;
    return nullptr;
  }
  ec_codec *c = new (std::nothrow) ec_codec();
  if (!c) {
    delete rg;
    return nullptr;
  }
  c->k = k;
  c->m = m;
  c->priv = rg;
  c->encode = regen_encode;
  c->decode = regen_decode;
  c->destroy = regen_destroy;
  return c;
}

ec_plugin g_plugin = {"regen_native", regen_factory};

}  // namespace

extern "C" {

const char *__erasure_code_version() { return CEPH_TPU_EC_VERSION; }

int __erasure_code_init(const char *name, const char *dir) {
  (void)dir;
  return ec_registry_add(name, &g_plugin);
}

}  // extern "C"
