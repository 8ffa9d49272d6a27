// FlashAttention-2 forward: out = softmax(q kᵀ / sqrt(D) + mask) v over
// the (B, S, H, D) layout, online softmax, f32 scores and statistics.
//
// Replaces: src/repro/kernels/flash_attention.py, flash_attention_single
// -> _flash_kernel (the Pallas kernel with a VMEM-resident q tile, a kv
// grid dimension swept in order, and running max / denominator /
// accumulator in VMEM scratch), which ops.flash_attention vmaps over batch
// and heads.
//
// What bounds it on an H100: operations.  It does 4·D flops for every
// (query, key) pair the mask keeps against 4·B·S·H·D·bytes of q, k, v and
// out, so at a model's head width and sequence length (D=128, S=4096) the
// products, not the reads, are the floor: 67 TFLOP/s in f32, 989 in bf16
// on the tensor cores.
//
// Design: one 256-thread block per (b·h, 64-query tile), all B·H heads in
// one launch, reading q, k, v and writing out straight through the
// (B, S, H, D) strides, so no transposed copy is made; offsets are 64-bit.
// The q tile is staged once in shared memory as f32; 64-key tiles of k
// and v stream through shared memory.  Each thread owns a 4x4 block of
// the 64x64 score tile and a 4x(D/16) block of the accumulator: scores
// are f32 dot products scaled by 1/sqrt(D); masked scores are -1e30 and
// their weights exact zeros (a padded key past Skv never wins); the row
// max and sum go through a 16-lane shuffle; p goes through shared memory
// for the PV product, rounded first to v's type as the reference does.
// The running m, l and accumulator stay f32 in registers.  Under the
// causal mask (key index <= query index, both from 0: top-left aligned,
// also when Sq != Skv) the key tiles wholly past a query tile are never
// read, and the heaviest query tiles are launched first.  D is a template
// constant for 64 and 128; any other D up to 256 takes a generic form.
// SIMT FMA throughout: no wgmma yet, a simple kernel that is right first.
#include "common.cuh"

namespace {

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int THREADS = 256;
constexpr int TX = 16;  // threads along keys (scores) and d (output)
constexpr int RQ = BQ / (THREADS / TX);  // 4 query rows a thread
constexpr int RK = BK / TX;              // 4 keys a thread
constexpr int MAX_D = 256;
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float half_warp_max(float v) {
#pragma unroll
  for (int off = TX / 2; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float half_warp_sum(float v) {
#pragma unroll
  for (int off = TX / 2; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// floats of shared memory for head width d
__host__ __device__ constexpr int64_t smem_floats(int d) {
  return 2 * static_cast<int64_t>(BQ) * (d + 1) + static_cast<int64_t>(BK) * d +
         static_cast<int64_t>(BQ) * (BK + 1);
}

// DT: the head width, or 0 for any width up to MAX_D given at run time.
template <typename T, int DT>
__global__ void __launch_bounds__(THREADS)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ out, int64_t Sq,
             int64_t Skv, int64_t H, int d_rt, float scale, bool causal) {
  constexpr int DJ = (DT > 0 ? DT : MAX_D) / TX;  // output columns a thread
  const int D = DT > 0 ? DT : d_rt;
  const int DP = D + 1;  // padded row: conflict-free column reads
  extern __shared__ float smem[];
  float* qs = smem;               // [BQ][DP]
  float* ks = qs + BQ * DP;       // [BK][DP]
  float* vs = ks + BK * DP;       // [BK][D]
  float* ps = vs + BK * D;        // [BQ][BK + 1]

  const int tid = threadIdx.x;
  const int tx = tid % TX;
  const int ty = tid / TX;
  const int64_t bh = blockIdx.x;
  const int64_t b = bh / H;
  const int64_t h = bh % H;
  const int64_t q0 = static_cast<int64_t>(gridDim.y - 1 - blockIdx.y) * BQ;
  const int64_t row = H * D;  // stride between sequence positions
  const T* qb = q + (b * Sq * H + h) * D;
  const T* kb = k + (b * Skv * H + h) * D;
  const T* vb = v + (b * Skv * H + h) * D;
  T* ob = out + (b * Sq * H + h) * D;

  for (int e = tid; e < BQ * D; e += THREADS) {
    const int r = e / D;
    const int d = e % D;
    qs[r * DP + d] = q0 + r < Sq ? to_f32(qb[(q0 + r) * row + d]) : 0.0f;
  }

  float m[RQ], l[RQ], acc[RQ][DJ];
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.0f;
  }

  // under the causal mask, key tiles starting past the tile's last query
  // are wholly masked
  const int64_t kv_end = causal ? (Skv < q0 + BQ ? Skv : q0 + BQ) : Skv;
  for (int64_t k0 = 0; k0 < kv_end; k0 += BK) {
    __syncthreads();  // the last tile's ks, vs, ps reads are done
    for (int e = tid; e < BK * D; e += THREADS) {
      const int r = e / D;
      const int d = e % D;
      const bool in = k0 + r < Skv;  // zeros past Skv: 0·p stays 0
      ks[r * DP + d] = in ? to_f32(kb[(k0 + r) * row + d]) : 0.0f;
      vs[r * D + d] = in ? to_f32(vb[(k0 + r) * row + d]) : 0.0f;
    }
    __syncthreads();

    float s[RQ][RK];
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int j = 0; j < RK; ++j) s[i][j] = 0.0f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float a[RQ], c[RK];
#pragma unroll
      for (int i = 0; i < RQ; ++i) a[i] = qs[(ty + i * (THREADS / TX)) * DP + d];
#pragma unroll
      for (int j = 0; j < RK; ++j) c[j] = ks[(tx + j * TX) * DP + d];
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int j = 0; j < RK; ++j) s[i][j] = fmaf(a[i], c[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      const int qr = ty + i * (THREADS / TX);
      const int64_t qidx = q0 + qr;
      bool ok[RK];
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < RK; ++j) {
        const int64_t kidx = k0 + tx + j * TX;
        ok[j] = kidx < Skv && (!causal || kidx <= qidx);
        s[i][j] = ok[j] ? s[i][j] * scale : NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], half_warp_max(mx));
      float psum = 0.0f;
#pragma unroll
      for (int j = 0; j < RK; ++j) {
        const float p = ok[j] ? expf(s[i][j] - m_new) : 0.0f;
        psum += p;
        ps[qr * (BK + 1) + tx + j * TX] = to_f32(from_f32<T>(p));
      }
      const float corr = expf(m[i] - m_new);
      l[i] = l[i] * corr + half_warp_sum(psum);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] *= corr;
    }
    __syncthreads();

    for (int kk = 0; kk < BK; ++kk) {
      float pv[RQ];
#pragma unroll
      for (int i = 0; i < RQ; ++i) pv[i] = ps[(ty + i * (THREADS / TX)) * (BK + 1) + kk];
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        const int d = tx + j * TX;
        if (DT == 0 && d >= D) break;
        const float vv = vs[kk * D + d];
#pragma unroll
        for (int i = 0; i < RQ; ++i) acc[i][j] = fmaf(pv[i], vv, acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int64_t qidx = q0 + ty + i * (THREADS / TX);
    if (qidx >= Sq) continue;
    const float inv_l = 1.0f / fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      const int d = tx + j * TX;
      if (DT == 0 && d >= D) break;
      ob[qidx * row + d] = from_f32<T>(acc[i][j] * inv_l);
    }
  }
}

template <typename T, int DT>
int launch(const void* q, const void* k, const void* v, void* out,
           int64_t B, int64_t Sq, int64_t Skv, int64_t H, int D, float scale,
           bool causal, cudaStream_t s) {
  const size_t bytes = sizeof(float) * smem_floats(D);
  // once per form: allow its largest shared-memory footprint
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_kernel<T, DT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(sizeof(float) * smem_floats(DT > 0 ? DT : MAX_D)));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid(static_cast<unsigned>(B * H),
                  static_cast<unsigned>((Sq + BQ - 1) / BQ));
  flash_kernel<T, DT><<<grid, THREADS, bytes, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), Sq, Skv, H, D, scale,
      causal);
  return launch_status();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* out,
             int64_t B, int64_t Sq, int64_t Skv, int64_t H, int D,
             float scale, bool causal, cudaStream_t s) {
  if (D == 64) return launch<T, 64>(q, k, v, out, B, Sq, Skv, H, D, scale, causal, s);
  if (D == 128) return launch<T, 128>(q, k, v, out, B, Sq, Skv, H, D, scale, causal, s);
  return launch<T, 0>(q, k, v, out, B, Sq, Skv, H, D, scale, causal, s);
}

}  // namespace

extern "C" int repro_flash_attention(int dtype, const void* q, const void* k,
                                     const void* v, void* out, long long B,
                                     long long Sq, long long Skv, long long H,
                                     int D, float scale, int causal,
                                     void* stream) {
  if (D < 1 || D > MAX_D) return -2;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kFloat32:
      return dispatch<float>(q, k, v, out, B, Sq, Skv, H, D, scale, causal != 0, s);
    case kBFloat16:
      return dispatch<__nv_bfloat16>(q, k, v, out, B, Sq, Skv, H, D, scale, causal != 0, s);
    default:
      return -1;
  }
}
