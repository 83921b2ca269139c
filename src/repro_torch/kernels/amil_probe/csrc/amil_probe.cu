// Batched AMIL residency probe.
//
// Replaces the Pallas TPU kernel src/repro/kernels/amil_probe/amil_probe.py
// (`_probe_kernel` / `amil_probe`).  For each request it gathers the packed
// int32 metadata lane at `slot`, unpacks tag[0:2] | valid[2] | dirty[3] |
// affinity[4:6] (the layout of core/amil.py), and emits int32
// hit = valid & tag == want & 3, dirty & hit, and affinity (amil_lane.cuh).
//
// What bounds it: bytes.  A request reads 8 B (slot, tag) and writes 12 B
// (three int32 lanes): 20 B per request, against ~10 integer operations,
// far below the card's operations-per-byte balance.  The table is small
// (<= 8192 lanes = 32 KiB in the sizes the reference names) and lives in
// shared memory, where the random gather costs no device-memory traffic.
// The design keeps the memory system busy and launches once a call:
//   * The range check is in the kernel: one unsigned compare a slot, and a
//     slot outside [0, n_slots) fails the stream with a device-side assert
//     (as torch's own index checks do) before the table is read.  The
//     wrapper launches nothing else.
//   * Requests go four at a time: 16-byte streaming loads of slots and
//     tags (ld.global.cs), 16-byte streaming stores (st.global.cs) of the
//     three outputs, and the N % 4 left over one by one in the same kernel.
//     Where one of the five streams is not 16-byte aligned (a view such as
//     slots[1:]), every request goes one by one (amil_span).
//   * Bytes in flight: each thread issues its next quad's loads before the
//     current quad's gather and stores, and its first quad's loads before
//     it waits for the table.
//   * The table comes in by one TMA bulk copy behind an mbarrier (a scalar
//     copy for a tail of under 16 bytes or a table that is not 16-byte
//     aligned), overlapped with the first quad's loads.  The mbarrier sits
//     in the dynamic shared memory ahead of the table (kTableOffset).
//   * One wave of 1024-thread CTAs (the fastest of 128-1024 on the card,
//     PERF.md): the grid is the occupancy calculator's CTAs per SM times the
//     SMs (fewer when the requests need fewer), each thread striding over
//     the quads.  The launcher asks the device once and caches the answer.
//   * A table over the device's opt-in shared memory (58,108 lanes on an
//     H100) runs the same kernel with the table left in device memory
//     (kShared = false): no staging, no mbarrier, every gather a 4-byte
//     load through L2 (50 MB on an H100, 12.5 M lanes), two CTAs an SM.
//     Still one launch a call and no host read.

#undef NDEBUG                      // the range check's assert in every build
#include <assert.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <map>
#include <mutex>

#include "amil_lane.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kTableOffset = 16;   // bytes: the mbarrier, then the table

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

// Spin until the phase of parity `parity` has completed; a wait that never
// ends (a lost copy) traps after 2^26 polls instead of hanging the stream.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  for (uint32_t polls = 0;; ++polls) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
    if (done) return;
    if (polls == (1u << 26)) __trap();
  }
}

// Bulk copy of `bytes` (a multiple of 16, both ends 16-byte aligned) from
// device memory into shared memory, counted on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// The stream fails here: a device-side assert, as torch._assert_async
// raises one.
__device__ __noinline__ void slot_out_of_range() {
  assert(!"amil_probe: a slot lies outside [0, n_slots)");
  __trap();
}

__device__ __forceinline__ void probe_one(const int32_t* table, int n_slots,
                                          const int32_t* slots,
                                          const int32_t* tags, int64_t i,
                                          int32_t* hit, int32_t* dirty,
                                          int32_t* aff) {
  int32_t h, d, a;
  if (!amil_one(table, n_slots, slots[i], tags[i], h, d, a))
    slot_out_of_range();
  __stcs(hit + i, h);
  __stcs(dirty + i, d);
  __stcs(aff + i, a);
}

// kShared: the table in shared memory (the TMA design, up to the
// device's opt-in shared memory); else read where it lies in device memory
// (a larger table: the gathers go through L2, which holds 12.5 M int32
// lanes on an H100).
template <bool kShared>
__global__ void __launch_bounds__(kThreads)
amil_probe_kernel(const int32_t* __restrict__ meta, int n_slots,
                  int bulk_slots, const int32_t* __restrict__ slots,
                  const int32_t* __restrict__ tags, int64_t quads, int64_t n,
                  int32_t* __restrict__ hit, int32_t* __restrict__ dirty,
                  int32_t* __restrict__ aff) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  const int32_t* table = meta;
  const int tid = threadIdx.x;
  if constexpr (kShared) {
    int32_t* staged = reinterpret_cast<int32_t*>(smem + kTableOffset);
    if (tid == 0 && bulk_slots > 0) {
      mbar_init(bar, 1);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
      mbar_expect_tx(bar, (uint32_t)bulk_slots * 4u);
      bulk_load(staged, meta, (uint32_t)bulk_slots * 4u, bar);
    }
    for (int i = bulk_slots + tid; i < n_slots; i += blockDim.x)
      staged[i] = meta[i];
    table = staged;
  }

  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const int64_t gid = (int64_t)blockIdx.x * blockDim.x + tid;
  const int4* s4 = reinterpret_cast<const int4*>(slots);
  const int4* t4 = reinterpret_cast<const int4*>(tags);
  int4* h4 = reinterpret_cast<int4*>(hit);
  int4* d4 = reinterpret_cast<int4*>(dirty);
  int4* a4 = reinterpret_cast<int4*>(aff);
  int64_t q = gid;
  int4 s = make_int4(0, 0, 0, 0), t = s;
  if (q < quads) {                 // in flight while the table arrives
    s = __ldcs(s4 + q);
    t = __ldcs(t4 + q);
  }
  if constexpr (kShared) {
    __syncthreads();               // the scalar part of the table
    if (bulk_slots > 0) mbar_wait(bar, 0);
  }

  while (q < quads) {
    const int64_t qn = q + stride;
    int4 sn = s, tn = t;
    if (qn < quads) {              // the next quad's loads, before this one
      sn = __ldcs(s4 + qn);
      tn = __ldcs(t4 + qn);
    }
    const int32_t sv[4] = {s.x, s.y, s.z, s.w};
    const int32_t tv[4] = {t.x, t.y, t.z, t.w};
    int32_t h[4], d[4], a[4];
    if (!amil_quad(table, n_slots, sv, tv, h, d, a)) slot_out_of_range();
    __stcs(h4 + q, make_int4(h[0], h[1], h[2], h[3]));
    __stcs(d4 + q, make_int4(d[0], d[1], d[2], d[3]));
    __stcs(a4 + q, make_int4(a[0], a[1], a[2], a[3]));
    q = qn;
    s = sn;
    t = tn;
  }

  // the requests after the quads (every request, where a stream is not
  // 16-byte aligned)
  for (int64_t i = 4 * quads + gid; i < n; i += stride)
    probe_one(table, n_slots, slots, tags, i, hit, dirty, aff);
}

// The SMs and the opt-in shared memory of device `dev`, asked once; the
// first call also raises the shared kernel's dynamic shared memory to the
// opt-in maximum.  Returns a CUDA error code.
int device_limits(int dev, int* n_sms, size_t* optin) {
  static std::mutex mu;
  static std::map<int, std::pair<int, size_t>> seen;
  std::lock_guard<std::mutex> lock(mu);
  auto d = seen.find(dev);
  if (d == seen.end()) {
    int sms = 0, max_smem = 0;
    cudaError_t e;
    if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess ||
        (e = cudaDeviceGetAttribute(
             &max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev)) !=
            cudaSuccess ||
        (e = cudaFuncSetAttribute(amil_probe_kernel<true>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  max_smem)) != cudaSuccess)
      return (int)e;
    d = seen.emplace(dev, std::make_pair(sms, (size_t)max_smem)).first;
  }
  *n_sms = d->second.first;
  *optin = d->second.second;
  return 0;
}

// The grid of one wave of the kernel (shared: holding a table of `smem`
// bytes) on device `dev`: CTAs per SM times SMs, each size's occupancy
// asked once.  Returns a CUDA error code.
int wave_blocks(int dev, int n_sms, bool shared, size_t smem,
                int64_t* blocks) {
  static std::mutex mu;
  static std::map<std::pair<int, size_t>, int> per_sm;
  std::lock_guard<std::mutex> lock(mu);
  const size_t key = shared ? smem : 0;    // the shared design's is >= 16
  auto o = per_sm.find({dev, key});
  if (o == per_sm.end()) {
    int n = 0;
    const cudaError_t e =
        shared ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                     &n, amil_probe_kernel<true>, kThreads, smem)
               : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                     &n, amil_probe_kernel<false>, kThreads, 0);
    if (e != cudaSuccess) return (int)e;
    if (n < 1) return (int)cudaErrorInvalidConfiguration;
    o = per_sm.emplace(std::make_pair(dev, key), n).first;
  }
  *blocks = (int64_t)o->second * n_sms;
  return 0;
}

}  // namespace

// The probe of n requests against an n_slots-lane table on device `dev`
// (the current device): the shared design while the table fits the
// device's opt-in shared memory, else the device-memory design.  Returns
// cudaGetLastError() after the launch (or the error that refused it).
extern "C" int amil_probe_launch(const int32_t* meta, int n_slots,
                                 const int32_t* slots, const int32_t* tags,
                                 int64_t n, int32_t* hit, int32_t* dirty,
                                 int32_t* aff, int dev, void* stream) {
  if (n <= 0) return 0;
  if (n_slots <= 0) return (int)cudaErrorInvalidValue;
  int n_sms = 0;
  size_t optin = 0;
  int e = device_limits(dev, &n_sms, &optin);
  if (e != 0) return e;
  const size_t smem = kTableOffset + (size_t)n_slots * sizeof(int32_t);
  const bool shared = smem <= optin;
  int64_t wave = 0;
  e = wave_blocks(dev, n_sms, shared, smem, &wave);
  if (e != 0) return e;
  const AmilSpan sp = amil_span(slots, tags, hit, dirty, aff, n);
  const int64_t work = sp.quads > sp.tail ? sp.quads : sp.tail;
  int64_t blocks = (work + kThreads - 1) / kThreads;
  if (blocks > wave) blocks = wave;
  if (blocks < 1) blocks = 1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!shared) {
    amil_probe_kernel<false><<<(int)blocks, kThreads, 0, st>>>(
        meta, n_slots, 0, slots, tags, sp.quads, n, hit, dirty, aff);
    return (int)cudaGetLastError();
  }
  const int bulk_slots =
      (reinterpret_cast<uintptr_t>(meta) & 15) == 0 ? (n_slots & ~3) : 0;
  amil_probe_kernel<true><<<(int)blocks, kThreads, smem, st>>>(
      meta, n_slots, bulk_slots, slots, tags, sp.quads, n, hit, dirty, aff);
  return (int)cudaGetLastError();
}
