// Kernels 6 and 7: the MFN recurrence's training forward (gamma-hidden hash
// dropout, every c_t saved) and its reverse-time backward.
//
// Replaces: multimodal_transformer_tpu/ops/pallas/mfn_train.py
//   kernel 6  _fwd_call (body _fwd_kernel);
//   kernel 7  _bwd_call (body _bwd_kernel).
//
// Kernel 6 is kernel B's step loop (mfn_common.cuh scan_kernel) with the
// gamma1/gamma2 hiddens dropped by the JAX package's fmix32 keep bit of
// position b * width + c under the step's seeds, and c_t written beside h_t
// and mem_t, all three in the storage dtype.
//
// Kernel 7 walks t from T-1 down to 0.  Each step rematerializes the forward
// step from the saved t-1 states (read back in the storage dtype, as the TPU
// kernel does), carries (dh, dc, dmem) in shared memory and writes d_xp_t.
// The parameter gradients are NOT accumulated inside the serial loop: the
// loop writes, per (video, step) row, every layer input it rematerialized
// (X) and every pre-activation gradient it computed (G), and after the loop
// each weight gradient is one deterministic split-K product dW = G^T X over
// all B*T rows (gemm.cuh weight_grad) and each bias gradient a column sum of
// G.  Transposed copies of the weights, made once per call, turn every
// backward matrix-vector product into row reads.
//
// What bounds it on the H100: the reverse loop is serial in t and tiny per
// step, like kernel B, so it is latency- and L2-bound; its ~17 dependent
// matrix-vector phases per step make it roughly twice the forward's step
// time.  The gradient products afterwards (~0.4 M weights x B*T rows) are
// large and parallel, on the FMA pipes.
//
// What the design does about it: the serial loop keeps only what must be
// serial (the carries and the per-step VJP), and everything that sums over
// rows moves out of it into products that fill the card.  No float atomics:
// the same inputs give bit-identical gradients.

#include "mfn_common.cuh"

namespace mmtx {
namespace mfnt {

using mfn::Args;
using mfn::Job;
using mfn::kMaxMods;
using mfn::kNone;
using mfn::kRelu;
using mfn::kSigmoid;
using mfn::kTanh;
using mfn::kThreads;

// Transposed weights of the backward's matrix-vector products, [in, out].
enum WT : int { A1W1T, A1W2T, A2W1T, A2W2T, GW1T, G1W2T, G2W2T, kNumWT };

struct Widths {
  int TH, TH2, MEM, h1, h2, hg1, hg2;
  // column offsets into the X (layer inputs) and G (pre-activation
  // gradients) rows
  int xo_hprev, xo_cstar, xo_ah, xo_both, xo_bh, xo_g1, xo_g2, XW;
  int go_dz, go_dapre, go_dlog, go_dbpre, go_dchat, go_dp1, go_ds1, go_dp2, go_ds2, GW;

  static Widths make(int TH, int MEM, int h1, int h2, int hg1, int hg2) {
    Widths w;
    w.TH = TH; w.TH2 = 2 * TH; w.MEM = MEM; w.h1 = h1; w.h2 = h2; w.hg1 = hg1; w.hg2 = hg2;
    int o = 0;
    w.xo_hprev = o; o += TH;
    w.xo_cstar = o; o += 2 * TH;
    w.xo_ah = o; o += h1;
    w.xo_both = o; o += 2 * TH + MEM;
    w.xo_bh = o; o += h2;
    w.xo_g1 = o; o += hg1;
    w.xo_g2 = o; o += hg2;
    w.XW = o;
    o = 0;
    w.go_dz = o; o += 4 * TH;
    w.go_dapre = o; o += h1;
    w.go_dlog = o; o += 2 * TH;
    w.go_dbpre = o; o += h2;
    w.go_dchat = o; o += MEM;
    w.go_dp1 = o; o += hg1;
    w.go_ds1 = o; o += MEM;
    w.go_dp2 = o; o += hg2;
    w.go_ds2 = o; o += MEM;
    w.GW = o;
    return w;
  }
};

struct BwdArgs {
  Args f;                        // shapes, xp, whh, gate weights, seeds, rates
  const void* hs;                // saved [B, T, TH] (storage dtype)
  const void* cs;
  const void* mems;              // [B, T, MEM]
  const float* g_hs;             // [B, T, TH]
  const float* g_mems;           // [B, T, MEM]
  void* dxp[kMaxMods];           // [B, T, 4H_m] (storage dtype)
  const void* whhT[kMaxMods];    // [H_m, 4H_m]
  const void* wT[kNumWT];
  float* X;                      // [B*T, XW]
  float* G;                      // [B*T, GW]
  Widths w;
};

// Shared memory of one backward block, in floats; carve() lays it out.
struct Smem {
  float *hp, *cp, *memp, *z, *ig, *fg, *gg, *og, *tc, *cstar, *apre, *ah, *logits, *att,
      *both, *bpre, *bh, *chat, *g1pre, *g1hd, *g2pre, *g2hd, *gam1, *gam2, *red;
  float *dmem_c, *dh_c, *dc_c, *ds1, *ds2, *dchat, *dmemp, *dhid, *dpre, *dbh, *dbpre, *dboth,
      *dattp, *datt, *dlog, *dcs, *dah, *dapre, *dcs2, *dz;

  // Points the members at consecutive pieces of p (when s and p are given)
  // and returns the total size in floats.
  __host__ __device__ static size_t carve(float* p, const Widths& w, Smem* s) {
    Smem d;
    Smem& m = s ? *s : d;
    const int TH = w.TH, TH2 = w.TH2, MEM = w.MEM;
    float** dst[] = {&m.hp, &m.cp, &m.memp, &m.z, &m.ig, &m.fg, &m.gg, &m.og, &m.tc,
                     &m.cstar, &m.apre, &m.ah, &m.logits, &m.att, &m.both, &m.bpre,
                     &m.bh, &m.chat, &m.g1pre, &m.g1hd, &m.g2pre, &m.g2hd, &m.gam1,
                     &m.gam2, &m.red, &m.dmem_c, &m.dh_c, &m.dc_c, &m.ds1, &m.ds2,
                     &m.dchat, &m.dmemp, &m.dhid, &m.dpre, &m.dbh, &m.dbpre, &m.dboth,
                     &m.dattp, &m.datt, &m.dlog, &m.dcs, &m.dah, &m.dapre, &m.dcs2, &m.dz};
    const int n[] = {TH, TH, MEM, 4 * TH, TH, TH, TH, TH, TH,
                     TH2, w.h1, w.h1, TH2, TH2, TH2 + MEM, w.h2,
                     w.h2, MEM, w.hg1, w.hg1, w.hg2, w.hg2, MEM,
                     MEM, 2, MEM, TH, TH, MEM, MEM,
                     MEM, MEM, w.hg1 + w.hg2, w.hg1 + w.hg2, w.h2, w.h2, TH2 + MEM,
                     TH2, TH2, TH2, TH2, w.h1, w.h1, TH2, 4 * TH};
    static_assert(sizeof(dst) / sizeof(dst[0]) == sizeof(n) / sizeof(n[0]),
                  "one size per piece");
    size_t o = 0;
    for (size_t i = 0; i < sizeof(n) / sizeof(n[0]); ++i) {
      *dst[i] = p ? p + o : nullptr;
      o += (size_t)n[i];
    }
    return o;
  }
};

template <typename T>
__global__ void __launch_bounds__(kThreads) bwd_scan_kernel(BwdArgs a) {
  extern __shared__ float sm[];
  Smem s;
  Smem::carve(sm, a.w, &s);
  const Args& f = a.f;
  const Widths& w = a.w;
  const int TH = w.TH, TH2 = w.TH2, MEM = w.MEM;
  const int b = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nt = blockDim.x, nwarps = nt >> 5;
  const void* const* gw = f.g;
  const T* hs = static_cast<const T*>(a.hs);
  const T* cs = static_cast<const T*>(a.cs);
  const T* mems = static_cast<const T*>(a.mems);

  int off[kMaxMods + 1];
  off[0] = 0;
  for (int m = 0; m < f.n_mods; ++m) off[m + 1] = off[m] + f.hid[m];

  for (int i = tid; i < TH; i += nt) { s.dh_c[i] = 0.f; s.dc_c[i] = 0.f; }
  for (int i = tid; i < MEM; i += nt) s.dmem_c[i] = 0.f;
  Job jobs[kMaxMods];

  for (int t = f.T - 1; t >= 0; --t) {
    __syncthreads();
    const size_t row = (size_t)b * f.T + t;
    float* X = a.X + row * w.XW;
    float* G = a.G + row * w.GW;
    const DropSite s1{f.seeds[2 * t], f.thr1, f.keep1};
    const DropSite s2{f.seeds[2 * t + 1], f.thr2, f.keep2};

    // ---- rematerialize step t from the saved t-1 states (zeros at t = 0)
    for (int i = tid; i < TH; i += nt) {
      s.hp[i] = t ? to_f(hs[(row - 1) * TH + i]) : 0.f;
      s.cp[i] = t ? to_f(cs[(row - 1) * TH + i]) : 0.f;
    }
    for (int i = tid; i < MEM; i += nt) s.memp[i] = t ? to_f(mems[(row - 1) * MEM + i]) : 0.f;
    __syncthreads();
    for (int m = 0; m < f.n_mods; ++m) {
      const int H = f.hid[m];
      const T* xp = static_cast<const T*>(f.xp[m]) + row * 4 * H;
      jobs[m] = Job{f.whh[m], s.hp + off[m], xp, s.z + 4 * off[m], H, 4 * H, kNone};
    }
    mfn::run_jobs<T>(jobs, f.n_mods, warp, nwarps, lane);
    __syncthreads();
    for (int i = tid; i < TH; i += nt) {
      int m = 0;
      while (i >= off[m + 1]) ++m;
      const int H = f.hid[m], j = i - off[m];
      const float* zm = s.z + 4 * off[m];
      const float ig = sigmoidf(zm[j]), fg = sigmoidf(zm[H + j]);
      const float gg = tanhf(zm[2 * H + j]), og = sigmoidf(zm[3 * H + j]);
      const float c_new = fg * s.cp[i] + ig * gg;
      s.ig[i] = ig; s.fg[i] = fg; s.gg[i] = gg; s.og[i] = og;
      s.tc[i] = tanhf(c_new);
      s.cstar[i] = s.cp[i];
      s.cstar[TH + i] = c_new;
      X[w.xo_hprev + i] = s.hp[i];
    }
    __syncthreads();
    jobs[0] = Job{gw[0], s.cstar, gw[1], s.apre, TH2, w.h1, kNone};
    mfn::run_jobs<T>(jobs, 1, warp, nwarps, lane);
    __syncthreads();
    for (int i = tid; i < w.h1; i += nt) {
      s.ah[i] = fmaxf(s.apre[i], 0.f);
      X[w.xo_ah + i] = s.ah[i];
    }
    for (int i = tid; i < TH2; i += nt) X[w.xo_cstar + i] = s.cstar[i];
    __syncthreads();
    jobs[0] = Job{gw[2], s.ah, gw[3], s.logits, w.h1, TH2, kNone};
    mfn::run_jobs<T>(jobs, 1, warp, nwarps, lane);
    __syncthreads();
    mfn::feature_softmax(s.logits, s.att, s.red, TH2, warp, lane, tid, nt);
    for (int i = tid; i < TH2; i += nt) {
      s.both[i] = s.att[i] * s.cstar[i];
      X[w.xo_both + i] = s.both[i];
    }
    for (int i = tid; i < MEM; i += nt) {
      s.both[TH2 + i] = s.memp[i];
      X[w.xo_both + TH2 + i] = s.memp[i];
    }
    __syncthreads();
    jobs[0] = Job{gw[4], s.both, gw[5], s.bpre, TH2, w.h2, kNone};
    jobs[1] = Job{gw[8], s.both, gw[9], s.g1pre, TH2 + MEM, w.hg1, kNone};
    jobs[2] = Job{gw[12], s.both, gw[13], s.g2pre, TH2 + MEM, w.hg2, kNone};
    mfn::run_jobs<T>(jobs, 3, warp, nwarps, lane);
    __syncthreads();
    for (int i = tid; i < w.h2; i += nt) {
      s.bh[i] = fmaxf(s.bpre[i], 0.f);
      X[w.xo_bh + i] = s.bh[i];
    }
    for (int i = tid; i < w.hg1; i += nt) {
      s.g1hd[i] = s1.apply(fmaxf(s.g1pre[i], 0.f), (uint32_t)(b * w.hg1 + i));
      X[w.xo_g1 + i] = s.g1hd[i];
    }
    for (int i = tid; i < w.hg2; i += nt) {
      s.g2hd[i] = s2.apply(fmaxf(s.g2pre[i], 0.f), (uint32_t)(b * w.hg2 + i));
      X[w.xo_g2 + i] = s.g2hd[i];
    }
    __syncthreads();
    jobs[0] = Job{gw[6], s.bh, gw[7], s.chat, w.h2, MEM, kTanh};
    jobs[1] = Job{gw[10], s.g1hd, gw[11], s.gam1, w.hg1, MEM, kSigmoid};
    jobs[2] = Job{gw[14], s.g2hd, gw[15], s.gam2, w.hg2, MEM, kSigmoid};
    mfn::run_jobs<T>(jobs, 3, warp, nwarps, lane);
    __syncthreads();

    // ---- the step's VJP
    // mem_t = gamma1 * mem_{t-1} + gamma2 * c^
    for (int i = tid; i < MEM; i += nt) {
      const float dm = a.g_mems[row * MEM + i] + s.dmem_c[i];
      const float g1 = s.gam1[i], g2 = s.gam2[i], ch = s.chat[i];
      s.ds1[i] = dm * s.memp[i] * g1 * (1.f - g1);
      s.ds2[i] = dm * ch * g2 * (1.f - g2);
      s.dchat[i] = dm * g2 * (1.f - ch * ch);
      s.dmemp[i] = dm * g1;
      G[w.go_ds1 + i] = s.ds1[i];
      G[w.go_ds2 + i] = s.ds2[i];
      G[w.go_dchat + i] = s.dchat[i];
    }
    __syncthreads();
    jobs[0] = Job{a.wT[G1W2T], s.ds1, nullptr, s.dhid, MEM, w.hg1, kNone};
    jobs[1] = Job{a.wT[G2W2T], s.ds2, nullptr, s.dhid + w.hg1, MEM, w.hg2, kNone};
    jobs[2] = Job{a.wT[A2W2T], s.dchat, nullptr, s.dbh, MEM, w.h2, kNone};
    mfn::run_jobs<T>(jobs, 3, warp, nwarps, lane);
    __syncthreads();
    for (int i = tid; i < w.hg1; i += nt) {
      const float v = s1.apply(s.dhid[i], (uint32_t)(b * w.hg1 + i));
      s.dpre[i] = s.g1pre[i] > 0.f ? v : 0.f;
      G[w.go_dp1 + i] = s.dpre[i];
    }
    for (int i = tid; i < w.hg2; i += nt) {
      const float v = s2.apply(s.dhid[w.hg1 + i], (uint32_t)(b * w.hg2 + i));
      s.dpre[w.hg1 + i] = s.g2pre[i] > 0.f ? v : 0.f;
      G[w.go_dp2 + i] = s.dpre[w.hg1 + i];
    }
    for (int i = tid; i < w.h2; i += nt) {
      s.dbpre[i] = s.bpre[i] > 0.f ? s.dbh[i] : 0.f;
      G[w.go_dbpre + i] = s.dbpre[i];
    }
    __syncthreads();
    // d[attended; mem] from both gamma MLPs in one product, d attended from att2
    jobs[0] = Job{a.wT[GW1T], s.dpre, nullptr, s.dboth, w.hg1 + w.hg2, TH2 + MEM, kNone};
    jobs[1] = Job{a.wT[A2W1T], s.dbpre, nullptr, s.dattp, w.h2, TH2, kNone};
    mfn::run_jobs<T>(jobs, 2, warp, nwarps, lane);
    __syncthreads();
    // attended = att * c*, att = softmax over the features
    float part = 0.f;
    for (int i = tid; i < TH2; i += nt) {
      const float da = s.dattp[i] + s.dboth[i];
      s.datt[i] = da * s.cstar[i];
      s.dcs[i] = da * s.att[i];
    }
    for (int i = tid; i < MEM; i += nt) s.dmemp[i] += s.dboth[TH2 + i];
    __syncthreads();
    if (warp == 0) {
      for (int i = lane; i < TH2; i += 32) part += s.datt[i] * s.att[i];
      part = warp_sum(part);
      if (lane == 0) s.red[0] = part;
    }
    __syncthreads();
    for (int i = tid; i < TH2; i += nt) {
      s.dlog[i] = s.att[i] * (s.datt[i] - s.red[0]);
      G[w.go_dlog + i] = s.dlog[i];
    }
    __syncthreads();
    jobs[0] = Job{a.wT[A1W2T], s.dlog, nullptr, s.dah, TH2, w.h1, kNone};
    mfn::run_jobs<T>(jobs, 1, warp, nwarps, lane);
    __syncthreads();
    for (int i = tid; i < w.h1; i += nt) {
      s.dapre[i] = s.apre[i] > 0.f ? s.dah[i] : 0.f;
      G[w.go_dapre + i] = s.dapre[i];
    }
    __syncthreads();
    jobs[0] = Job{a.wT[A1W1T], s.dapre, nullptr, s.dcs2, w.h1, TH2, kNone};
    mfn::run_jobs<T>(jobs, 1, warp, nwarps, lane);
    __syncthreads();
    // LSTM cells: c_t = f c_{t-1} + i g, h_t = o tanh(c_t)
    for (int i = tid; i < TH; i += nt) {
      int m = 0;
      while (i >= off[m + 1]) ++m;
      const int H = f.hid[m], j = i - off[m];
      const float ig = s.ig[i], fg = s.fg[i], gg = s.gg[i], og = s.og[i], tc = s.tc[i];
      const float dh = a.g_hs[row * TH + i] + s.dh_c[i];
      float dcf = s.dc_c[i] + s.dcs[TH + i] + s.dcs2[TH + i];
      const float d_o = dh * tc;
      dcf += dh * og * (1.f - tc * tc);
      const float di = dcf * gg, df = dcf * s.cp[i], dg = dcf * ig;
      s.dc_c[i] = dcf * fg + s.dcs[i] + s.dcs2[i];
      const float dz[4] = {di * ig * (1.f - ig), df * fg * (1.f - fg), dg * (1.f - gg * gg),
                           d_o * og * (1.f - og)};
      float* dzm = s.dz + 4 * off[m];
      T* dxp = static_cast<T*>(a.dxp[m]) + row * 4 * H;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        dzm[q * H + j] = dz[q];
        dxp[q * H + j] = from_f<T>(dz[q]);
        G[w.go_dz + 4 * off[m] + q * H + j] = dz[q];
      }
    }
    __syncthreads();
    for (int m = 0; m < f.n_mods; ++m) {
      const int H = f.hid[m];
      jobs[m] = Job{a.whhT[m], s.dz + 4 * off[m], nullptr, s.dh_c + off[m], 4 * H, H, kNone};
    }
    mfn::run_jobs<T>(jobs, f.n_mods, warp, nwarps, lane);
    for (int i = tid; i < MEM; i += nt) s.dmem_c[i] = s.dmemp[i];
  }
}

// out[c * ldo + col0 + r] = in[r * C + c]: a [R, C] matrix transposed into
// columns col0.. of an [C, ldo] one.
template <typename T>
__global__ void transpose_kernel(const T* __restrict__ in, int R, int C, T* __restrict__ out,
                                 int ldo, int col0) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= (long long)R * C) return;
  const int r = (int)(i / C), c = (int)(i % C);
  out[(long long)c * ldo + col0 + r] = in[i];
}

template <typename T>
void transpose(const void* in, int R, int C, void* out, int ldo, int col0, cudaStream_t st) {
  const long long n = (long long)R * C;
  transpose_kernel<T><<<(unsigned)((n + 255) / 256), 256, 0, st>>>(
      static_cast<const T*>(in), R, C, static_cast<T*>(out), ldo, col0);
}

// The backward's scratch, carved from one workspace allocation.
template <typename T>
struct Work {
  T* whhT[kMaxMods];
  T* wT[kNumWT];
  float* X;
  float* G;
  float* part;
  static Work carve(Carver& c, const Args& f, const Widths& w) {
    Work k;
    for (int m = 0; m < kMaxMods; ++m)
      k.whhT[m] = m < f.n_mods ? c.take<T>((size_t)4 * f.hid[m] * f.hid[m]) : nullptr;
    const int gin = w.TH2 + w.MEM;
    const size_t sizes[kNumWT] = {(size_t)w.TH2 * w.h1, (size_t)w.h1 * w.TH2,
                                  (size_t)w.TH2 * w.h2, (size_t)w.h2 * w.MEM,
                                  (size_t)gin * (w.hg1 + w.hg2), (size_t)w.hg1 * w.MEM,
                                  (size_t)w.hg2 * w.MEM};
    for (int i = 0; i < kNumWT; ++i) k.wT[i] = c.take<T>(sizes[i]);
    const size_t M = (size_t)f.B * f.T;
    k.X = c.take<float>(M * w.XW);
    k.G = c.take<float>(M * w.GW);
    size_t nk = 0;
    const size_t cand[6] = {(size_t)w.h1 * w.TH2, (size_t)w.h2 * w.TH2,
                            (size_t)w.MEM * w.h2, (size_t)w.hg1 * gin,
                            (size_t)w.hg2 * gin, (size_t)w.MEM * (w.hg1 > w.hg2 ? w.hg1 : w.hg2)};
    for (size_t v : cand) nk = v > nk ? v : nk;
    for (int m = 0; m < f.n_mods; ++m) {
      const size_t v = (size_t)4 * f.hid[m] * f.hid[m];
      nk = v > nk ? v : nk;
    }
    k.part = c.take<float>((size_t)grad_splits((int)M) * nk);
    return k;
  }
};

template <typename T>
int train_bwd(BwdArgs a, void* const* dwhh, void* const* dgates, void* ws, cudaStream_t st) {
  const Args& f = a.f;
  const Widths& w = a.w;
  Carver c{static_cast<char*>(ws)};
  Work<T> k = Work<T>::carve(c, f, w);
  const int gin = w.TH2 + w.MEM;
  // transposed weights: [in, out] = rows of the backward products
  for (int m = 0; m < f.n_mods; ++m) {
    const int H = f.hid[m];
    transpose<T>(f.whh[m], 4 * H, H, k.whhT[m], 4 * H, 0, st);
    a.whhT[m] = k.whhT[m];
  }
  transpose<T>(f.g[0], w.h1, w.TH2, k.wT[A1W1T], w.h1, 0, st);
  transpose<T>(f.g[2], w.TH2, w.h1, k.wT[A1W2T], w.TH2, 0, st);
  transpose<T>(f.g[4], w.h2, w.TH2, k.wT[A2W1T], w.h2, 0, st);
  transpose<T>(f.g[6], w.MEM, w.h2, k.wT[A2W2T], w.MEM, 0, st);
  transpose<T>(f.g[8], w.hg1, gin, k.wT[GW1T], w.hg1 + w.hg2, 0, st);
  transpose<T>(f.g[12], w.hg2, gin, k.wT[GW1T], w.hg1 + w.hg2, w.hg1, st);
  transpose<T>(f.g[10], w.MEM, w.hg1, k.wT[G1W2T], w.MEM, 0, st);
  transpose<T>(f.g[14], w.MEM, w.hg2, k.wT[G2W2T], w.MEM, 0, st);
  for (int i = 0; i < kNumWT; ++i) a.wT[i] = k.wT[i];
  a.X = k.X;
  a.G = k.G;

  const size_t smem = Smem::carve(nullptr, w, nullptr) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(bwd_scan_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  bwd_scan_kernel<T><<<f.B, kThreads, smem, st>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  // parameter gradients over all B*T rows, torch layout [out, in]
  const int M = f.B * f.T;
  const float* X = k.X;
  const float* G = k.G;
  int o = 0;
  for (int m = 0; m < f.n_mods; ++m) {
    const int H = f.hid[m];
    weight_grad<float, float>(G + w.go_dz + 4 * o, w.GW, X + w.xo_hprev + o, w.XW, M, 4 * H,
                              H, static_cast<float*>(dwhh[m]), k.part, st);
    o += H;
  }
  struct Lin { int go, n, xo, kin; };
  // gate order: att1 fc1/fc2, att2 fc1/fc2, gamma1 fc1/fc2, gamma2 fc1/fc2
  const Lin lins[8] = {{w.go_dapre, w.h1, w.xo_cstar, w.TH2}, {w.go_dlog, w.TH2, w.xo_ah, w.h1},
                       {w.go_dbpre, w.h2, w.xo_both, w.TH2},  {w.go_dchat, w.MEM, w.xo_bh, w.h2},
                       {w.go_dp1, w.hg1, w.xo_both, gin},     {w.go_ds1, w.MEM, w.xo_g1, w.hg1},
                       {w.go_dp2, w.hg2, w.xo_both, gin},     {w.go_ds2, w.MEM, w.xo_g2, w.hg2}};
  for (int j = 0; j < 8; ++j) {
    const Lin& l = lins[j];
    weight_grad<float, float>(G + l.go, w.GW, X + l.xo, w.XW, M, l.n, l.kin,
                              static_cast<float*>(dgates[2 * j]), k.part, st);
    colsum<float>(G + l.go, w.GW, M, l.n, static_cast<float*>(dgates[2 * j + 1]), st);
  }
  return (int)cudaGetLastError();
}

inline bool widths_ok(const Args& f) {
  const int ws[6] = {f.mem, f.h_att1, f.h_att2, f.h_g1, f.h_g2, f.total_h};
  for (int v : ws)
    if (v < 2 || v % 2) return false;
  for (int m = 0; m < f.n_mods; ++m)
    if (f.hid[m] < 2 || f.hid[m] % 2) return false;
  return true;
}

}  // namespace mfnt
}  // namespace mmtx

// Kernel 6.  As mmtx_mfn_scan, plus cs (every c_t, storage dtype), the
// per-step seeds [T, 2] uint32 on the device, and the gamma1/gamma2 drop
// thresholds and keep probabilities.
extern "C" int mmtx_mfn_train_fwd(int dtype, const void* xp, const void* whh,
                                  const void* hid, int n_mods, const void* gates,
                                  const void* seeds, unsigned thr1, unsigned thr2,
                                  float keep1, float keep2, void* hs, void* cs,
                                  void* mems, int B, int T, int mem, int h_att1,
                                  int h_att2, int h_g1, int h_g2, void* stream) {
  using namespace mmtx;
  mfn::Args a;
  if (!mfn::fill_args(a, xp, whh, hid, n_mods, gates, B, T, mem, h_att1, h_att2, h_g1,
                      h_g2) ||
      !mfnt::widths_ok(a))
    return (int)cudaErrorInvalidValue;
  a.hs = hs;
  a.mems = mems;
  a.cs = cs;
  a.seeds = static_cast<const uint32_t*>(seeds);
  a.thr1 = thr1; a.thr2 = thr2; a.keep1 = keep1; a.keep2 = keep2;
  const size_t smem = mfn::smem_floats(a) * sizeof(float);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kF32) {
    mfn::scan_kernel<float, true><<<B, mfn::kThreads, smem, st>>>(a);
  } else if (dtype == kBF16) {
    mfn::scan_kernel<__nv_bfloat16, true><<<B, mfn::kThreads, smem, st>>>(a);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// Workspace bytes of kernel 7.
extern "C" long long mmtx_mfn_train_workspace(int dtype, const void* hid, int n_mods, int B,
                                              int T, int mem, int h_att1, int h_att2,
                                              int h_g1, int h_g2) {
  using namespace mmtx;
  mfn::Args a;
  const void* dummy[mfn::kMaxMods] = {nullptr, nullptr, nullptr, nullptr};
  const void* g16[16] = {};
  if (!mfn::fill_args(a, dummy, dummy, hid, n_mods, g16, B, T, mem, h_att1, h_att2, h_g1,
                      h_g2))
    return -1;
  const mfnt::Widths w = mfnt::Widths::make(a.total_h, mem, h_att1, h_att2, h_g1, h_g2);
  Carver c{nullptr};
  if (dtype == kBF16)
    mfnt::Work<__nv_bfloat16>::carve(c, a, w);
  else
    mfnt::Work<float>::carve(c, a, w);
  return (long long)c.used + 256;
}

// Kernel 7.  xp/whh/hid/gates as kernel 6; hs, cs, mems: kernel 6's saved
// states; g_hs [B, T, total_h] and g_mems [B, T, mem]: fp32 cotangents;
// dxp: host array of n_mods device pointers [B, T, 4H_m] (storage dtype);
// dwhh: n_mods fp32 [4H_m, H_m]; dgates: 16 fp32 buffers shaped like the
// gate tensors.  Every output is written whole.
extern "C" int mmtx_mfn_train_bwd(int dtype, const void* xp, const void* whh,
                                  const void* hid, int n_mods, const void* gates,
                                  const void* seeds, unsigned thr1, unsigned thr2,
                                  float keep1, float keep2, const void* hs,
                                  const void* cs, const void* mems, const void* g_hs,
                                  const void* g_mems, const void* dxp, const void* dwhh,
                                  const void* dgates, void* workspace, int B, int T,
                                  int mem, int h_att1, int h_att2, int h_g1, int h_g2,
                                  void* stream) {
  using namespace mmtx;
  mfnt::BwdArgs a;
  if (!mfn::fill_args(a.f, xp, whh, hid, n_mods, gates, B, T, mem, h_att1, h_att2, h_g1,
                      h_g2) ||
      !mfnt::widths_ok(a.f))
    return (int)cudaErrorInvalidValue;
  a.f.seeds = static_cast<const uint32_t*>(seeds);
  a.f.thr1 = thr1; a.f.thr2 = thr2; a.f.keep1 = keep1; a.f.keep2 = keep2;
  a.hs = hs;
  a.cs = cs;
  a.mems = mems;
  a.g_hs = static_cast<const float*>(g_hs);
  a.g_mems = static_cast<const float*>(g_mems);
  void* const* dx = static_cast<void* const*>(const_cast<void*>(dxp));
  for (int m = 0; m < mfn::kMaxMods; ++m) a.dxp[m] = m < n_mods ? dx[m] : nullptr;
  a.w = mfnt::Widths::make(a.f.total_h, mem, h_att1, h_att2, h_g1, h_g2);
  void* const* dw = static_cast<void* const*>(const_cast<void*>(dwhh));
  void* const* dg = static_cast<void* const*>(const_cast<void*>(dgates));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kF32) return mfnt::train_bwd<float>(a, dw, dg, workspace, st);
  if (dtype == kBF16) return mfnt::train_bwd<__nv_bfloat16>(a, dw, dg, workspace, st);
  return (int)cudaErrorInvalidValue;
}
