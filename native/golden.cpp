// Independent scalar TS38.212 oracle — encoder, BP decoder core, and the
// full transport-block decode chain.
//
// Plays the role MathWorks' nrULSCH plays for the reference (testbench.m:59-68):
// a second, independently written implementation that the JAX chain must
// match bit-for-bit across the randomized parameter space.  Deliberately uses
// DIFFERENT algorithms from the JAX path wherever possible:
//   - LDPC parity is solved by dense GF(2) Gaussian elimination on the 4Z x 4Z
//     core block (not the rotation-cancellation trick),
//   - rate matching is the literal spec while-loop with filler markers (not a
//     precomputed gather), and its inverse is the literal scatter-accumulate
//     (not the reshape/roll composition of ops/rate_match.py),
//   - CRC is bit-serial long division (not a generator-matrix matmul),
//   - the BP decoder builds the lifted adjacency scalar-by-scalar from the
//     spec tables (not the shared base-graph roll plan).
//
// Exposed via a C ABI for ctypes (no pybind11 in this image).
//
// Build: make -C native   (produces libgolden.so)

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>
#include <vector>

#include "base_graphs.h"

namespace {

constexpr int8_t FILLER = -1;  // marks <NULL> filler bits in d

// Matches models/decoder.py FILLER_LLR: large finite stand-in for the
// reference's +inf filler LLRs (NRLDPCDecoder.m:264).
constexpr float FILLER_LLR = 1e20f;

struct CrcPoly {
  const int *taps;
  int ntaps;
  int len;
};

// TS38.212 Section 5.1 polynomial exponents.
const int CRC24A_T[] = {24, 23, 18, 17, 14, 11, 10, 7, 6, 5, 4, 3, 1, 0};
const int CRC24B_T[] = {24, 23, 6, 5, 1, 0};
const int CRC16_T[] = {16, 12, 5, 0};

CrcPoly crc24a{CRC24A_T, 14, 24};
CrcPoly crc24b{CRC24B_T, 6, 24};
CrcPoly crc16{CRC16_T, 4, 16};

// Bit-serial CRC long division: returns L parity bits (MSB-of-poly first).
void crc_bits(const uint8_t *msg, int n, const CrcPoly &p, uint8_t *out) {
  std::vector<uint8_t> buf(n + p.len, 0);
  std::memcpy(buf.data(), msg, n);
  std::vector<uint8_t> g(p.len + 1, 0);
  for (int i = 0; i < p.ntaps; ++i) g[p.len - p.taps[i]] = 1;
  for (int i = 0; i < n; ++i)
    if (buf[i])
      for (int j = 0; j <= p.len; ++j) buf[i + j] ^= g[j];
  std::memcpy(out, buf.data() + n, p.len);
}

// CRC pass check: remainder of the received (payload ++ crc) word is zero.
bool crc_passes(const uint8_t *word, int n, const CrcPoly &p) {
  if (n <= p.len) return false;
  std::vector<uint8_t> rem(p.len);
  crc_bits(word, n - p.len, p, rem.data());
  for (int i = 0; i < p.len; ++i)
    if (rem[i] != word[n - p.len + i]) return false;
  return true;
}

// TS38.212 Table 5.3.2-1.
const int kLiftSets[8][8] = {
    {2, 4, 8, 16, 32, 64, 128, 256}, {3, 6, 12, 24, 48, 96, 192, 384},
    {5, 10, 20, 40, 80, 160, 320, 0}, {7, 14, 28, 56, 112, 224, 0, 0},
    {9, 18, 36, 72, 144, 288, 0, 0},  {11, 22, 44, 88, 176, 352, 0, 0},
    {13, 26, 52, 104, 208, 0, 0, 0},  {15, 30, 60, 120, 240, 0, 0, 0}};

int lifting_size(int K_b, int K_prime, int *i_ls_out) {
  int best = 1 << 30;
  for (int s = 0; s < 8; ++s)
    for (int j = 0; j < 8 && kLiftSets[s][j]; ++j) {
      int z = kLiftSets[s][j];
      if ((long)K_b * z >= K_prime && z < best) best = z;
    }
  if (best == (1 << 30)) return -1;
  for (int s = 0; s < 8; ++s)
    for (int j = 0; j < 8 && kLiftSets[s][j]; ++j)
      if (kLiftSets[s][j] == best) {
        *i_ls_out = s;
        return best;
      }
  return -1;
}

int set_index_of(int Z) {
  for (int s = 0; s < 8; ++s)
    for (int j = 0; j < 8 && kLiftSets[s][j]; ++j)
      if (kLiftSets[s][j] == Z) return s;
  return -1;
}

// All derived TS38.212 parameters shared by encode and decode
// (NRLDPC.m:297-543 equivalents; independently re-derived here).
struct Derived {
  const CrcPoly *tb_poly;
  int L_cb;  // 24 when C > 1, else 0
  long B, B_prime, K_prime;
  int C, K_b, Z, i_ls, kb_full, n_rows, n_cols;
  long K, N, N_cb, k0;
  std::vector<int> flags;  // CBGTI schedule flags, length C
  int C_prime;
  std::vector<long> E_r;  // per-CB rate-matched lengths
};

// Returns 0 on success; negative = unsupported parameters.
int derive(int BG, int A, long G, int Q_m, int N_L, int rv_id, int I_LBRM,
           long TBS_LBRM, const int *CBGTI, int n_cbgti, Derived *p) {
  if (BG < 1 || BG > 2 || A < 0 || G < 0 || rv_id < 0 || rv_id > 3) return -1;
  if (Q_m != 1 && Q_m != 2 && Q_m != 4 && Q_m != 6 && Q_m != 8) return -1;
  if (N_L < 1 || N_L > 4) return -1;
  if (G % ((long)Q_m * N_L) != 0) return -2;

  p->tb_poly = (A > 3824) ? &crc24a : &crc16;
  p->B = A + p->tb_poly->len;
  long K_cb = (BG == 1) ? 8448 : 3840;
  if (p->B <= K_cb) {
    p->C = 1;
    p->L_cb = 0;
  } else {
    p->L_cb = 24;
    p->C = (int)((p->B + (K_cb - 24) - 1) / (K_cb - 24));
  }
  p->B_prime = (p->B <= K_cb) ? p->B : p->B + (long)p->C * p->L_cb;
  if (p->B_prime % p->C != 0) return -3;
  p->K_prime = p->B_prime / p->C;
  if (BG == 1) {
    p->K_b = 22;
  } else {
    if (p->K_prime > 640) p->K_b = 10;
    else if (p->K_prime > 560) p->K_b = 9;
    else if (p->K_prime > 192) p->K_b = 8;
    else p->K_b = 6;
  }
  p->Z = lifting_size(p->K_b, (int)p->K_prime, &p->i_ls);
  if (p->Z < 0) return -4;
  p->kb_full = (BG == 1) ? 22 : 10;
  p->K = (long)p->kb_full * p->Z;
  p->n_rows = (BG == 1) ? 46 : 42;
  p->n_cols = (BG == 1) ? 68 : 52;
  p->N = (long)(p->n_cols - 2) * p->Z;  // 66Z / 50Z

  long N_ref = (I_LBRM && TBS_LBRM >= 0) ? (3 * TBS_LBRM) / (2 * p->C) : p->N;
  p->N_cb = I_LBRM ? std::min(p->N, N_ref) : p->N;

  p->flags.assign(p->C, 1);
  for (int i = 0; i < n_cbgti; ++i)
    if (CBGTI[i] < p->C) p->flags[CBGTI[i]] = 0;
  p->C_prime = 0;
  for (int r = 0; r < p->C; ++r) p->C_prime += p->flags[r];
  if (p->C_prime == 0) return -5;

  long unit = (long)N_L * Q_m;
  long q = G / unit;
  p->E_r.assign(p->C, 0);
  {
    int j = 0;
    for (int r = 0; r < p->C; ++r) {
      if (!p->flags[r]) continue;
      if (j <= p->C_prime - (int)(q % p->C_prime) - 1)
        p->E_r[r] = unit * (q / p->C_prime);
      else
        p->E_r[r] = unit * ((q + p->C_prime - 1) / p->C_prime);
      ++j;
    }
  }

  {
    long num;
    int den = (BG == 1) ? 66 : 50;
    if (BG == 1)
      num = (rv_id == 0) ? 0 : (rv_id == 1) ? 17 : (rv_id == 2) ? 33 : 56;
    else
      num = (rv_id == 0) ? 0 : (rv_id == 1) ? 13 : (rv_id == 2) ? 25 : 43;
    p->k0 = (num * p->N_cb) / ((long)den * p->Z) * p->Z;
  }
  return 0;
}

// Dense GF(2) solve of the 4Z x 4Z core system B * p = rhs.
// Returns false if singular.
bool solve_core(const std::vector<std::vector<uint64_t>> &B_rows,
                std::vector<uint8_t> &rhs, int n, std::vector<uint8_t> &sol) {
  int words = (n + 63) / 64;
  std::vector<std::vector<uint64_t>> M = B_rows;  // copy, n rows x words
  std::vector<uint8_t> r = rhs;
  std::vector<int> pivot_col(n, -1);
  int row = 0;
  for (int col = 0; col < n && row < n; ++col) {
    int sel = -1;
    for (int i = row; i < n; ++i)
      if ((M[i][col >> 6] >> (col & 63)) & 1) {
        sel = i;
        break;
      }
    if (sel < 0) continue;
    std::swap(M[sel], M[row]);
    std::swap(r[sel], r[row]);
    for (int i = 0; i < n; ++i) {
      if (i == row) continue;
      if ((M[i][col >> 6] >> (col & 63)) & 1) {
        for (int w = 0; w < words; ++w) M[i][w] ^= M[row][w];
        r[i] ^= r[row];
      }
    }
    pivot_col[row] = col;
    ++row;
  }
  if (row < n) return false;
  sol.assign(n, 0);
  for (int i = 0; i < n; ++i) sol[pivot_col[i]] = r[i];
  return true;
}

// phi(x) = -log(tanh(x/2)) with the same clamps as the XLA reference
// (ops/decoder.py:_phi: clip to [1e-9, 38] then evaluate in f32) — and,
// since round 3, the same ROUNDING: xla_tanh_f32 / xla_log_f32 below
// reproduce XLA:CPU's vectorized f32 tanh and log approximations
// bit-for-bit (validated on 400k samples spanning the phi domain,
// tools/exp_xla_phi.py), so the whole sum-product trajectory is bit-exact
// vs the JAX flooding path instead of tolerance-checked.  The recipes
// were reverse-engineered empirically from XLA's emitted code:
//
//   tanh: Eigen-family 13/7-degree rational in x^2 (FMA-contracted),
//         identity below |x| < 4e-4, saturation to +-1 at
//         |x| >= 7.99881172180175781.
//   log:  cephes/Eigen mantissa-polynomial with the three-way split
//         evaluation, the e*q1 term carried as the addend of the final
//         polynomial FMA, and x - x^2/2 summed before the polynomial.
//
// The explicit std::fma calls are the contract; the surrounding ops must
// NOT be re-contracted (the Makefile pins -ffp-contract=off).
float xla_tanh_f32(float x) {
  const float kTiny = 0.0004f;
  const float kSat = 7.99881172180175781f;
  const float ax = std::fabs(x);
  if (ax < kTiny) return x;
  if (ax >= kSat) return x > 0 ? 1.0f : -1.0f;
  const float x2 = x * x;
  float p = -2.76076847742355e-16f;
  p = std::fma(p, x2, 2.00018790482477e-13f);
  p = std::fma(p, x2, -8.60467152213735e-11f);
  p = std::fma(p, x2, 5.12229709037114e-08f);
  p = std::fma(p, x2, 1.48572235717979e-05f);
  p = std::fma(p, x2, 6.37261928875436e-04f);
  p = std::fma(p, x2, 4.89352455891786e-03f);
  p = p * x;
  float q = 1.19825839466702e-06f;
  q = std::fma(q, x2, 1.18534705686654e-04f);
  q = std::fma(q, x2, 2.26843463243900e-03f);
  q = std::fma(q, x2, 4.89352518554385e-03f);
  return p / q;
}

float xla_log_f32(float xin) {
  const float sqrthf = 0.707106781186547524f;
  const float q1 = -2.12194440e-4f, q2 = 0.693359375f;
  uint32_t bits;
  std::memcpy(&bits, &xin, 4);
  const int eint = (int)(bits >> 23) - 126;
  bits = (bits & 0x007fffffu) | 0x3f000000u;  // mantissa in [0.5, 1)
  float x;
  std::memcpy(&x, &bits, 4);
  float e = (float)eint;
  const float tmp = (x < sqrthf) ? x : 0.0f;
  e -= (x < sqrthf) ? 1.0f : 0.0f;
  x = x - 1.0f;
  x = x + tmp;
  const float x2 = x * x, x3 = x2 * x;
  float y, y1, y2;
  y = std::fma(7.0376836292e-2f, x, -1.1514610310e-1f);
  y1 = std::fma(-1.2420140846e-1f, x, 1.4249322787e-1f);
  y2 = std::fma(2.0000714765e-1f, x, -2.4999993993e-1f);
  y = std::fma(y, x, 1.1676998740e-1f);
  y1 = std::fma(y1, x, -1.6668057665e-1f);
  y2 = std::fma(y2, x, 3.3333331174e-1f);
  y = std::fma(y, x3, y1);
  y = std::fma(y, x3, y2);
  y = std::fma(y, x3, e * q1);
  x = x - x2 * 0.5f;
  x = x + y;
  return std::fma(e, q2, x);
}

float phi_f(float x) {
  x = std::min(std::max(x, 1e-9f), 38.0f);
  return -xla_log_f32(xla_tanh_f32(x * 0.5f));
}

// Internal BP decode core; totals_out optional (may be nullptr).
int decode_core_impl(int BG, int Z, int iterations, int algorithm, float alpha,
                     float beta, const float *llr, uint8_t *bits_out,
                     int *ok_out, int *iters_out, float *totals_out) {
  if (BG < 1 || BG > 2 || Z < 2 || iterations < 0) return -1;
  if (algorithm < 0 || algorithm > 2) return -1;
  int i_ls = set_index_of(Z);
  if (i_ls < 0) return -2;  // Z not a valid lifting size

  const int *bg_row = (BG == 1) ? BG1_ROW : BG2_ROW;
  const int *bg_col = (BG == 1) ? BG1_COL : BG2_COL;
  const int *bg_shift = (BG == 1) ? BG1_SHIFT : BG2_SHIFT;
  const int n_edges = (BG == 1) ? BG1_EDGES : BG2_EDGES;
  const int n_rows = (BG == 1) ? 46 : 42;
  const int n_cols = (BG == 1) ? 68 : 52;
  const int nv = n_cols * Z;

  std::vector<int> shift(n_edges);
  for (int e = 0; e < n_edges; ++e) shift[e] = bg_shift[e * 8 + i_ls] % Z;
  std::vector<std::vector<int>> row_edges(n_rows);
  for (int e = 0; e < n_edges; ++e) row_edges[bg_row[e]].push_back(e);

  std::vector<float> totals(llr, llr + nv);
  std::vector<float> c2v((size_t)n_edges * Z, 0.0f);

  auto syndrome_ok = [&]() {
    for (int r = 0; r < n_rows; ++r)
      for (int z = 0; z < Z; ++z) {
        int par = 0;
        for (int e : row_edges[r])
          par ^= (totals[bg_col[e] * Z + (z + shift[e]) % Z] < 0.0f);
        if (par) return false;
      }
    return true;
  };

  std::vector<float> acc(nv);
  std::vector<uint8_t> touched(nv);
  std::vector<float> v, ph;
  std::vector<int> vari;
  int updates = 0;
  for (;;) {
    if (syndrome_ok()) {
      *ok_out = 1;
      *iters_out = updates;
      break;
    }
    if (updates >= iterations) {
      *ok_out = 0;
      *iters_out = iterations;
      break;
    }
    // one flooding sweep: all checks read the same pre-sweep totals
    std::fill(touched.begin(), touched.end(), 0);
    for (int r = 0; r < n_rows; ++r) {
      const std::vector<int> &edges = row_edges[r];
      const int deg = (int)edges.size();
      v.assign(deg, 0.0f);
      vari.assign(deg, 0);
      if (algorithm == 2) ph.assign(deg, 0.0f);
      for (int z = 0; z < Z; ++z) {
        for (int i = 0; i < deg; ++i) {
          const int e = edges[i];
          vari[i] = bg_col[e] * Z + (z + shift[e]) % Z;
          v[i] = totals[vari[i]] - c2v[(size_t)e * Z + z];
        }
        if (algorithm == 2) {
          // sum-product: phi-domain sum in ascending edge order, exactly
          // like decoder_fast's `T = phis[0]; for p in phis[1:]: T += p`
          float T = 0.0f;
          int sp = 1;
          for (int i = 0; i < deg; ++i) {
            ph[i] = phi_f(std::fabs(v[i]));
            T = (i == 0) ? ph[i] : T + ph[i];
            sp *= (v[i] < 0.0f) ? -1 : 1;
          }
          for (int i = 0; i < deg; ++i) {
            const float mag = phi_f(std::max(T - ph[i], 1e-9f));
            const int se = (v[i] < 0.0f) ? -1 : 1;
            const float out = (sp * se > 0) ? mag : -mag;
            c2v[(size_t)edges[i] * Z + z] = out;
            const int var = vari[i];
            acc[var] = touched[var] ? acc[var] + out : out;
            touched[var] = 1;
          }
          continue;
        }
        // two smallest magnitudes (running scan, strict-< first-min index
        // like the JAX scan; ties make m2 == m1 so the index is moot)
        float m1 = std::fabs(v[0]);
        float m2 = std::numeric_limits<float>::infinity();
        int idx = 0;
        int sp = (v[0] < 0.0f) ? -1 : 1;
        for (int i = 1; i < deg; ++i) {
          const float av = std::fabs(v[i]);
          if (av < m1) {
            m2 = m1;
            m1 = av;
            idx = i;
          } else {
            m2 = std::min(m2, av);
          }
          sp *= (v[i] < 0.0f) ? -1 : 1;
        }
        for (int i = 0; i < deg; ++i) {
          float mag = (i == idx) ? m2 : m1;
          mag = (algorithm == 0) ? alpha * mag
                                 : std::max(mag - beta, 0.0f);
          const int se = (v[i] < 0.0f) ? -1 : 1;
          const float out = (sp * se > 0) ? mag : -mag;
          c2v[(size_t)edges[i] * Z + z] = out;
          const int var = vari[i];
          // first-touch assignment replicates decoder_fast's accumulator
          // seeding (col_acc[c] = back on first use), so the f32 addition
          // chain per variable is identical term for term
          acc[var] = touched[var] ? acc[var] + out : out;
          touched[var] = 1;
        }
      }
    }
    for (int k = 0; k < nv; ++k)
      totals[k] = touched[k] ? llr[k] + acc[k] : llr[k];
    ++updates;
  }
  for (int k = 0; k < nv; ++k) bits_out[k] = totals[k] < 0.0f;
  if (totals_out) std::memcpy(totals_out, totals.data(), nv * sizeof(float));
  return 0;
}

// TS38.211 Section 5.1 constellation point for the Q_m-bit pattern m
// (MSB-first, i.e. bit b(Q_m*i) of the stream is the MSB of symbol i).
// All-f64 evaluation of the spec formulas — the independent oracle for
// ops/modulation.py (which the reference gets for free from the toolbox's
// separately-validated comm.PSK/RectangularQAM objects, NRModulator.m:69-85).
void constellation_point(int qm, unsigned m, double *re, double *im) {
  double s[8];
  for (int i = 0; i < qm; ++i)
    s[i] = 1.0 - 2.0 * (double)((m >> (qm - 1 - i)) & 1u);
  switch (qm) {
    case 1:  // BPSK (pi/4): d = ((1-2b) + j(1-2b)) / sqrt(2)
      *re = s[0] / std::sqrt(2.0);
      *im = s[0] / std::sqrt(2.0);
      return;
    case 2:  // QPSK
      *re = s[0] / std::sqrt(2.0);
      *im = s[1] / std::sqrt(2.0);
      return;
    case 4:  // 16QAM
      *re = s[0] * (2.0 - s[2]) / std::sqrt(10.0);
      *im = s[1] * (2.0 - s[3]) / std::sqrt(10.0);
      return;
    case 6:  // 64QAM
      *re = s[0] * (4.0 - s[2] * (2.0 - s[4])) / std::sqrt(42.0);
      *im = s[1] * (4.0 - s[3] * (2.0 - s[5])) / std::sqrt(42.0);
      return;
    case 8:  // 256QAM
      *re = s[0] * (8.0 - s[2] * (4.0 - s[4] * (2.0 - s[6]))) /
            std::sqrt(170.0);
      *im = s[1] * (8.0 - s[3] * (4.0 - s[5] * (2.0 - s[7]))) /
            std::sqrt(170.0);
      return;
    default:
      *re = *im = std::numeric_limits<double>::quiet_NaN();
  }
}

// Numerically stable f64 log-sum-exp over the metrics collected in `v`.
double lse(const std::vector<double> &v) {
  double m = -std::numeric_limits<double>::infinity();
  for (double x : v) m = std::max(m, x);
  if (!std::isfinite(m)) return m;
  double acc = 0.0;
  for (double x : v) acc += std::exp(x - m);
  return m + std::log(acc);
}

}  // namespace

extern "C" {

// Maps n_bits bits (a multiple of Q_m) to n_bits/Q_m complex symbols in f64.
// Q_m selects the modulation: 1=BPSK 2=QPSK 4=16QAM 6=64QAM 8=256QAM.
// Returns 0 on success, negative on bad arguments.
int nr_golden_modulate(int Q_m, const uint8_t *bits, long n_bits,
                       double *re_out, double *im_out) {
  if (Q_m != 1 && Q_m != 2 && Q_m != 4 && Q_m != 6 && Q_m != 8) return -1;
  if (n_bits % Q_m != 0) return -2;
  const long S = n_bits / Q_m;
  for (long k = 0; k < S; ++k) {
    unsigned m = 0;
    for (int i = 0; i < Q_m; ++i)
      m = (m << 1) | (bits[k * Q_m + i] & 1u);
    constellation_point(Q_m, m, re_out + k, im_out + k);
  }
  return 0;
}

// Soft-demodulates n_syms complex symbols to n_syms*Q_m LLRs in f64
// (positive = bit 0, matching MATLAB comm demodulators / NRDemodulator.m:5).
// method: 0 = exact log-sum-exp LLR, 1 = max-log, 2 = hard (+/-1e30).
//
// Deliberately a different algorithm from ops/modulation.py: the full
// 2^Q_m-point metric with a scalar stable LSE per bit, instead of the JAX
// path's per-axis PAM factorization — so an error in the PAM decomposition
// or the logsumexp masking shows up as a differential mismatch.
int nr_golden_demodulate(int Q_m, int method, double noise_var,
                         const double *re, const double *im, long n_syms,
                         double *llr_out) {
  if (Q_m != 1 && Q_m != 2 && Q_m != 4 && Q_m != 6 && Q_m != 8) return -1;
  if (method < 0 || method > 2 || !(noise_var > 0.0)) return -2;
  const int M = 1 << Q_m;
  std::vector<double> cre(M), cim(M);
  for (int m = 0; m < M; ++m) constellation_point(Q_m, (unsigned)m, &cre[m], &cim[m]);
  std::vector<double> metric(M);
  std::vector<double> v0, v1;
  for (long k = 0; k < n_syms; ++k) {
    for (int m = 0; m < M; ++m) {
      const double dr = re[k] - cre[m], di = im[k] - cim[m];
      metric[m] = -(dr * dr + di * di) / noise_var;
    }
    for (int b = 0; b < Q_m; ++b) {
      v0.clear();
      v1.clear();
      for (int m = 0; m < M; ++m)
        (((m >> (Q_m - 1 - b)) & 1) ? v1 : v0).push_back(metric[m]);
      double l0, l1;
      if (method == 0) {
        l0 = lse(v0);
        l1 = lse(v1);
      } else {
        l0 = *std::max_element(v0.begin(), v0.end());
        l1 = *std::max_element(v1.begin(), v1.end());
      }
      double llr = l0 - l1;
      if (method == 2) llr = (llr >= 0.0) ? 1e30 : -1e30;
      llr_out[k * Q_m + b] = llr;
    }
  }
  return 0;
}

// Vectorized phi for the bit-exactness CI guard (tests/test_conformance.py
// checks it against the JAX _phi element-for-element; a mismatch means the
// XLA version changed its f32 tanh/log rounding and the contract must be
// re-measured).
void nr_golden_phi(const float *x, float *out, long n) {
  for (long i = 0; i < n; ++i) out[i] = phi_f(x[i]);
}

// Returns 0 on success; negative = unsupported parameters; positive = bug.
// a: A bits in {0,1}.  g_out: G bits.
int nr_golden_encode(int BG, int A, long G, int Q_m, int N_L, int rv_id,
                     int I_LBRM, long TBS_LBRM, const int *CBGTI, int n_cbgti,
                     const uint8_t *a, uint8_t *g_out) {
  Derived dp;
  int rc = derive(BG, A, G, Q_m, N_L, rv_id, I_LBRM, TBS_LBRM, CBGTI, n_cbgti,
                  &dp);
  if (rc != 0) return rc;
  const int C = dp.C;
  const int Z = dp.Z;
  const long K = dp.K, K_prime = dp.K_prime, N = dp.N, N_cb = dp.N_cb;
  const int L_cb = dp.L_cb, kb_full = dp.kb_full, n_cols = dp.n_cols;
  const int i_ls = dp.i_ls;

  // --- Section 5.1: TB CRC ---
  std::vector<uint8_t> b(dp.B);
  std::memcpy(b.data(), a, A);
  crc_bits(a, A, *dp.tb_poly, b.data() + A);

  // --- Section 5.2.2: segmentation, per-code-block bits with filler marks ---
  std::vector<std::vector<int8_t>> c(C, std::vector<int8_t>(K, 0));
  {
    long s = 0;
    for (int r = 0; r < C; ++r) {
      std::vector<uint8_t> payload(K_prime - L_cb);
      for (long k = 0; k < K_prime - L_cb; ++k) {
        payload[k] = b[s++];
        c[r][k] = payload[k];
      }
      if (C > 1) {
        uint8_t p[24];
        crc_bits(payload.data(), (int)payload.size(), crc24b, p);
        for (int k = 0; k < L_cb; ++k) c[r][K_prime - L_cb + k] = p[k];
      }
      for (long k = K_prime; k < K; ++k) c[r][k] = FILLER;
    }
  }

  // --- Section 5.3.2: LDPC encoding ---
  const int *bg_row = (BG == 1) ? BG1_ROW : BG2_ROW;
  const int *bg_col = (BG == 1) ? BG1_COL : BG2_COL;
  const int *bg_shift = (BG == 1) ? BG1_SHIFT : BG2_SHIFT;
  int n_edges = (BG == 1) ? BG1_EDGES : BG2_EDGES;

  // Build the 4Z x 4Z core parity matrix (bitset rows) once.
  int n_core = 4 * Z;
  int words = (n_core + 63) / 64;
  std::vector<std::vector<uint64_t>> core(n_core,
                                          std::vector<uint64_t>(words, 0));
  for (int e = 0; e < n_edges; ++e) {
    int r = bg_row[e], col = bg_col[e];
    if (r < 4 && col >= kb_full && col < kb_full + 4) {
      int s = bg_shift[e * 8 + i_ls] % Z;
      for (int z = 0; z < Z; ++z) {
        int check = r * Z + z;
        int var = (col - kb_full) * Z + (z + s) % Z;
        core[check][var >> 6] ^= 1ull << (var & 63);
      }
    }
  }

  std::vector<std::vector<int8_t>> d(C, std::vector<int8_t>(N, 0));
  for (int r_cb = 0; r_cb < C; ++r_cb) {
    // encode with fillers treated as 0
    std::vector<uint8_t> cb(K);
    for (long k = 0; k < K; ++k) cb[k] = (c[r_cb][k] == FILLER) ? 0 : c[r_cb][k];

    // core syndromes lambda_i (i < 4) from systematic columns
    std::vector<uint8_t> rhs(n_core, 0);
    for (int e = 0; e < n_edges; ++e) {
      int r = bg_row[e], col = bg_col[e];
      if (r < 4 && col < kb_full) {
        int s = bg_shift[e * 8 + i_ls] % Z;
        for (int z = 0; z < Z; ++z)
          rhs[r * Z + z] ^= cb[(long)col * Z + (z + s) % Z];
      }
    }
    std::vector<uint8_t> p_core;
    if (!solve_core(core, rhs, n_core, p_core)) return 1;

    // full codeword bits: systematic + core parity + extension parity
    std::vector<uint8_t> cw((long)n_cols * Z, 0);
    std::memcpy(cw.data(), cb.data(), K);
    for (int i = 0; i < n_core; ++i) cw[K + i] = p_core[i];
    for (int e = 0; e < n_edges; ++e) {
      int r = bg_row[e], col = bg_col[e];
      if (r >= 4 && col < kb_full + 4) {
        int s = bg_shift[e * 8 + i_ls] % Z;
        for (int z = 0; z < Z; ++z)
          cw[K + 4ll * Z + (long)(r - 4) * Z + z] ^=
              cw[(long)col * Z + (z + s) % Z];
      }
    }

    // d = cw[2Z:] with filler markers restored (NRLDPCEncoder.m:149-156)
    for (long k = 2l * Z; k < K; ++k)
      d[r_cb][k - 2 * Z] = (c[r_cb][k] == FILLER) ? FILLER : (int8_t)cw[k];
    for (long k = K; k < N + 2l * Z; ++k) d[r_cb][k - 2 * Z] = (int8_t)cw[k];
  }

  // --- Sections 5.4.2.1 / 5.4.2.2 / 5.5: rate matching + concatenation ---
  long out_pos = 0;
  for (int r = 0; r < C; ++r) {
    if (dp.E_r[r] == 0) continue;
    // Section 5.4.2.1 bit selection: literal spec while-loop
    std::vector<uint8_t> e(dp.E_r[r]);
    long k = 0, j = 0;
    while (k < dp.E_r[r]) {
      int8_t v = d[r][(dp.k0 + j) % N_cb];
      if (v != FILLER) e[k++] = (uint8_t)v;
      ++j;
    }
    // Section 5.4.2.2 interleaving: f[i + j*Q_m] = e[i*(E/Q_m) + j]
    long EoQ = dp.E_r[r] / Q_m;
    for (long jj = 0; jj < EoQ; ++jj)
      for (int i = 0; i < Q_m; ++i)
        g_out[out_pos + i + jj * Q_m] = e[i * EoQ + jj];
    out_pos += dp.E_r[r];
  }
  return (out_pos == G) ? 0 : 2;
}

// Independent scalar flooding BP decoder over the lifted PCM — the decoder
// conformance oracle.  The JAX decoders (ops/decoder.py, decoder_fast.py,
// decoder_layered.py) all share the base-graph edge plan
// (_row_plan), so a bug there would be invisible to their cross-checks; this
// implementation builds the lifted adjacency scalar-by-scalar straight from
// the spec tables and runs the textbook per-check update.
//
// Bit-exactness contract (min-sum / offset-min-sum): every operation in
// the flooding min-sum trajectory is either exact (min, compare, sign flip,
// subtraction of previously-identical values) or a single f32 rounding with a
// deterministic association order (alpha*mag, mag-beta, the per-column
// accumulation in ascending check-row order, channel + accumulator).  This
// replicates ops/decoder_fast.py's order exactly, so decoded bits, the
// parity flag, AND the early-termination iteration count must match
// bit-for-bit.  Sum-product (algorithm 2) follows the same schedule and the
// same phi clamps but evaluates phi with libm, whose tanh/log round
// differently from XLA's vectorized approximations — so SP agreement is
// tolerance-based: posterior totals match to relative precision and hard
// decisions may differ only where |total| is near zero (the test contract
// lives in tests/test_conformance.py).  ``totals_out`` (nullable) exposes
// the posterior LLRs for exactly that comparison.
//
// Semantics (comm.LDPCDecoder 'Parity check satisfied', NRLDPCDecoder.m:120):
// check the syndrome BEFORE each update; on pass, report the totals the
// syndrome was computed on and the number of updates applied so far; stop
// after `iterations` updates either way.
//
// algorithm: 0 = normalized min-sum (alpha), 1 = offset min-sum (beta),
//            2 = sum-product (phi function, clamps as ops/decoder.py).
// llr: n_cols*Z channel LLRs (positive = bit 0), the full lifted layout
// including the 2Z punctured columns (zeros) — same input as the JAX cores.
int nr_golden_decode_core(int BG, int Z, int iterations, int algorithm,
                          float alpha, float beta, const float *llr,
                          uint8_t *bits_out, int *ok_out, int *iters_out,
                          float *totals_out) {
  return decode_core_impl(BG, Z, iterations, algorithm, alpha, beta, llr,
                          bits_out, ok_out, iters_out, totals_out);
}

// Full transport-block decode chain oracle — the independent counterpart of
// models/decoder.py::decode_transport_block (NRLDPCDecoder.m:133-340):
// code-block split, Section 5.4.2.2 deinterleave, Section 5.4.2.1 inverse
// (literal scatter-accumulate with Chase combining of repeated positions),
// HARQ d-buffer accumulation, 2Z punctured zeros + filler pinning to
// +FILLER_LLR, flooding BP per code block, CB-CRC gating with CBGTI
// scheduling, b-buffer merge, and the TB CRC + all-code-blocks-latched gate.
//
// HARQ state (d_buf: C*N_cb floats, b_buf: B bits, cb_ok: C flags) is
// caller-owned and updated in place — pass zeroed buffers for a fresh
// transport block (the reference's reset(), NRLDPCDecoder.m:343-356).
// use_harq=0 skips only the d_buf accumulation into this transmission
// (models/decoder.py decodes standalone the same way when state is None).
//
// For the min-sum family the whole chain is bit-exact vs
// decode_transport_block(backend='fast', schedule='flooding') provided the
// circular buffer wraps at most 3 times (repetition count <= 3: beyond that
// XLA's reduction tree over the repetition axis may associate differently
// than this sequential accumulate; every standard-rate config is far below
// that).  Outputs: a_hat (A bits), tb_ok, per-CB cb_crc_ok / parity_ok /
// iters_used.
//
// Returns 0 on success; negative = unsupported parameters.
int nr_golden_decode(int BG, int A, long G, int Q_m, int N_L, int rv_id,
                     int I_LBRM, long TBS_LBRM, const int *CBGTI, int n_cbgti,
                     int iterations, int algorithm, float alpha, float beta,
                     const float *g_tilde, int use_harq, float *d_buf,
                     uint8_t *b_buf, uint8_t *cb_ok, uint8_t *a_hat,
                     int *tb_ok, uint8_t *cb_crc_ok, int *parity_ok,
                     int *iters_used) {
  Derived dp;
  int rc = derive(BG, A, G, Q_m, N_L, rv_id, I_LBRM, TBS_LBRM, CBGTI, n_cbgti,
                  &dp);
  if (rc != 0) return rc;
  const int C = dp.C, Z = dp.Z, Q = Q_m;
  const long K = dp.K, K_prime = dp.K_prime, N = dp.N, N_cb = dp.N_cb;
  const int L_cb = dp.L_cb;
  const long payload = K_prime - L_cb;
  const int n_cols = dp.n_cols;
  const long nv = (long)n_cols * Z;

  // Filler positions in d coordinates: [K' - 2Z, K - 2Z) clipped to >= 0
  // (NRLDPCDecoder.m:224; ops/rate_match.py filler_range_d).
  const long f_lo = std::max(K_prime - 2 * Z, 0l);
  const long f_hi = std::max(K - 2 * Z, 0l);

  std::vector<float> d_tilde(N);
  std::vector<float> cw_llr(nv);
  std::vector<uint8_t> bits(nv);
  std::vector<uint8_t> cbword(K_prime);

  long in_pos = 0;
  for (int r = 0; r < C; ++r) {
    const long E = dp.E_r[r];
    std::fill(d_tilde.begin(), d_tilde.end(), 0.0f);
    if (E > 0) {
      // Section 5.4.2.2 inverse: e[i*(E/Q_m) + j] = f[i + j*Q_m]
      const long EoQ = E / Q;
      std::vector<float> e_t(E);
      for (long jj = 0; jj < EoQ; ++jj)
        for (int i = 0; i < Q; ++i)
          e_t[i * EoQ + jj] = g_tilde[in_pos + i + jj * Q];
      in_pos += E;
      // Section 5.4.2.1 inverse: literal scatter-accumulate along the
      // filler-skipping circular read (Chase combining of repeats in
      // ascending wrap order, NRLDPCDecoder.m:228-234).
      long k = 0, j = 0;
      while (k < E) {
        long pos = (dp.k0 + j) % N_cb;
        if (!(pos >= f_lo && pos < f_hi)) d_tilde[pos] += e_t[k++];
        ++j;
      }
    }
    if (use_harq)
      for (long i = 0; i < N_cb; ++i) d_tilde[i] += d_buf[(long)r * N_cb + i];
    for (long i = 0; i < N_cb; ++i) d_buf[(long)r * N_cb + i] = d_tilde[i];

    // Rebuild the codeword LLRs: 2Z punctured zeros + d, fillers pinned.
    for (int i = 0; i < 2 * Z; ++i) cw_llr[i] = 0.0f;
    for (long i = 0; i < N; ++i) cw_llr[2 * Z + i] = d_tilde[i];
    for (long i = K_prime; i < K; ++i) cw_llr[i] = FILLER_LLR;

    int ok = 0, used = 0;
    rc = decode_core_impl(BG, Z, iterations, algorithm, alpha, beta,
                          cw_llr.data(), bits.data(), &ok, &used, nullptr);
    if (rc != 0) return rc;
    parity_ok[r] = ok;
    iters_used[r] = used;

    // Section 5.2.2 inverse: CB CRC gate (only when C > 1) + CBGTI schedule.
    bool crc_ok;
    if (C > 1) {
      std::memcpy(cbword.data(), bits.data(), K_prime);
      crc_ok = crc_passes(cbword.data(), (int)K_prime, crc24b);
    } else {
      crc_ok = true;
    }
    cb_crc_ok[r] = crc_ok;
    const bool accept = crc_ok && dp.flags[r];
    if (accept) {
      std::memcpy(b_buf + (long)r * payload, bits.data(), payload);
      cb_ok[r] = 1;
    }
  }

  // Section 5.1 inverse: TB CRC over the merged buffer + all-latched gate.
  bool all_latched = true;
  for (int r = 0; r < C; ++r) all_latched &= (cb_ok[r] != 0);
  *tb_ok = all_latched && crc_passes(b_buf, (int)dp.B, *dp.tb_poly);
  std::memcpy(a_hat, b_buf, A);
  return 0;
}

// Convenience: expose derived parameters for cross-checking the Python engine.
int nr_golden_params(int BG, int A, long G, int Q_m, int N_L, int rv_id,
                     int I_LBRM, long TBS_LBRM, long *out /* 8 slots */) {
  Derived dp;
  int rc = derive(BG, A, G, Q_m, N_L, rv_id, I_LBRM, TBS_LBRM, nullptr, 0,
                  &dp);
  if (rc != 0) return rc;
  out[0] = dp.C;
  out[1] = dp.K_prime;
  out[2] = dp.K_b;
  out[3] = dp.Z;
  out[4] = dp.i_ls;
  out[5] = dp.K;
  out[6] = dp.N;
  out[7] = dp.B;
  return 0;
}

}  // extern "C"
