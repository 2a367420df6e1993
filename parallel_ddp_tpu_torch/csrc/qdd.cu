// Forward-dynamics kernel: qdd = M^{-1}(tau - C) (B, 7) of the Kuka iiwa-14
// for a batch of samples x (B, 14), u (B, 7).
//
// Replaces: parallel_ddp_tpu/ops/pallas_rbd.py::_qdd_kernel (pallas_call at
// pallas_rbd.py:86), which runs soa.qdd_channels on (8, 128) lane tiles of
// 1024 samples, one scalar channel per VMEM tile.
//
// What bounds it on the H100: one evaluation is a ~2k-operation dataflow on
// 84 bytes in and 28 out, so the launch is latency-bound by that chain: at the
// block re-rollout's B = 1 it is the launch and one evaluation; at the FD
// Jacobian's 2,646 samples and the batched dynamics benchmark's 8,192 it is
// 83 and 256 blocks of one evaluation each on 132 SMs (~1 MB moved in all).
//
// Design: the group core (kuka_soa_group.cuh), as rollout.cu and rbd_jac.cu
// run it.  A block of KG_WARPS warps takes 32 samples, lane l of every warp
// sample l, so the roles of an evaluation run side by side in the warps and
// its chain is the longest role of each stage, not the whole operation
// count.  Warp w < 7 loads element w of q, qd and tau, takes cos/sin of joint
// w and at the end stores qdd[w].  The constants are staged in shared memory
// once a block.  A first version ran one sample in one thread (kuka_soa.cuh's
// kuka_qdd), 64 threads a block.

#include <cuda_runtime.h>

#include "kuka_soa_group.cuh"

#define QDD_NX (2 * KUKA_NJ)

__global__ void __launch_bounds__(KG_THREADS)
qdd_kernel(const float* __restrict__ cc_g, const float* __restrict__ x,
           const float* __restrict__ u, float* __restrict__ qdd, int batch) {
  __shared__ float cc[KC_SIZE];
  __shared__ float ws[KG_FIELDS * KG_LANES];
  const int lane = threadIdx.x & (KG_LANES - 1), w = threadIdx.x >> 5;
  const int b = blockIdx.x * KG_LANES + lane;
  const bool valid = b < batch;
  const size_t bc = valid ? b : batch - 1;     // spare lanes repeat the last sample, store nothing

  for (int i = threadIdx.x; i < KC_SIZE; i += KG_THREADS) cc[i] = cc_g[i];
  KgCol<float> col{ws + lane};
  if (w < KUKA_NJ) {
    col[KG_X + w] = x[bc * QDD_NX + w];
    col[KG_X + KUKA_NJ + w] = x[bc * QDD_NX + KUKA_NJ + w];
    col[KG_TAU + w] = u[bc * KUKA_NJ + w];
    kg_trig(col, w);
  }
  __syncthreads();
  kuka_qdd_group_after_trig(cc, col, w);
  __syncthreads();
  if (valid && w < KUKA_NJ) qdd[bc * KUKA_NJ + w] = col[KG_QDD + w];
}

extern "C" int pddp_qdd(const float* consts, const float* x, const float* u, float* qdd,
                        int batch, void* stream) {
  if (batch <= 0) return 0;
  const int blocks = (batch + KG_LANES - 1) / KG_LANES;
  qdd_kernel<<<blocks, KG_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(consts, x, u, qdd,
                                                                          batch);
  return static_cast<int>(cudaGetLastError());
}
