// Batched AMIL residency probe.
//
// Replaces the Pallas TPU kernel src/repro/kernels/amil_probe/amil_probe.py
// (`_probe_kernel` / `amil_probe`).  For each request it gathers the packed
// int32 metadata lane at `slot`, unpacks tag[0:2] | valid[2] | dirty[3] |
// affinity[4:6] (the layout of core/amil.py), and emits int32
// hit = valid & tag == want & 3, dirty & hit, and affinity.
//
// What bounds it: bytes.  A request reads 8 B (slot, tag) and writes 12 B
// (three int32 lanes): 20 B per request, against ~10 integer operations,
// far below the card's operations-per-byte balance.  The table itself is
// small (<= 8192 lanes = 32 KiB in the sizes the reference names), so the
// design stages it once per block in shared memory, where the random gather
// costs no device-memory traffic, and streams the requests with coalesced
// loads and stores, one thread per request in a grid-stride loop.  The
// wrapper caps the grid at two 1024-thread blocks per SM, so the table is
// staged a few hundred times, not once per block of requests.

#include <cuda_runtime.h>
#include <stdint.h>

__global__ void amil_probe_kernel(const int32_t* __restrict__ meta,
                                  int n_slots,
                                  const int32_t* __restrict__ slots,
                                  const int32_t* __restrict__ tags, int64_t n,
                                  int32_t* __restrict__ hit,
                                  int32_t* __restrict__ dirty,
                                  int32_t* __restrict__ aff) {
  extern __shared__ int32_t table[];
  for (int i = threadIdx.x; i < n_slots; i += blockDim.x) table[i] = meta[i];
  __syncthreads();
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const int32_t m = table[slots[i]];
    const int32_t want = tags[i] & 3;
    const int32_t h = (((m >> 2) & 1) == 1) && ((m & 3) == want);
    hit[i] = h;
    dirty[i] = ((m >> 3) & 1) & h;
    aff[i] = (m >> 4) & 3;
  }
}

extern "C" int amil_probe_launch(const int32_t* meta, int n_slots,
                                 const int32_t* slots, const int32_t* tags,
                                 int64_t n, int32_t* hit, int32_t* dirty,
                                 int32_t* aff, int max_blocks, void* stream) {
  const int threads = 1024;
  const size_t smem = (size_t)n_slots * sizeof(int32_t);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        amil_probe_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  int64_t blocks = (n + threads - 1) / threads;
  if (blocks > max_blocks) blocks = max_blocks;
  if (blocks < 1) blocks = 1;
  amil_probe_kernel<<<(int)blocks, threads, smem, (cudaStream_t)stream>>>(
      meta, n_slots, slots, tags, n, hit, dirty, aff);
  return (int)cudaGetLastError();
}
