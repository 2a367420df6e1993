"""Fused block-Riccati backward sweep: the CUDA kernel and its plain version.

Twin of `parallel_ddp_tpu/ops/pallas_riccati.py`.  The factory
`make_riccati_block_call(cfg, n, m)` returns

    bp(rho, seeds_P (Mb,n,n), seeds_p (Mb,n), AB_blk (Mb,Nb,n,n+m),
       H_blk (Mb,Nb,n+m,n+m), g_blk (Mb,Nb,n+m), d_blk (Mb,Nb,n),
       k_blk (Mb,Nb) global step indices)
      -> (P (Mb*Nb,n,n), p, K, du, ApBK, Bdu, dJexp (2,), fail bool)

one rho attempt of the block-parallel backward pass (backPassKern,
bpHelpers.cuh:336-420):
  * on CPU tensors, the plain version: `parallel/backward.py::run_block` over
    all block lanes at once (the per-step recursion `make_riccati_step`);
  * on CUDA tensors, the kernel `csrc/riccati.cu` (one thread block per
    lane, the cost-to-go in shared memory across the block's steps), or it
    raises.
rho is per lane inside the kernel; dJ is summed per lane in the kernel and
across lanes here, and fail is the OR of the lanes.
"""

from __future__ import annotations

import torch

from parallel_ddp_tpu_torch.ops import build
from parallel_ddp_tpu_torch.parallel.backward import make_riccati_step, run_block

# static shared-memory sizing of csrc/riccati.cu
MAX_N = 16
MAX_M = 8


def riccati_cuda(rho_l, seeds_P, seeds_p, AB_blk, H_blk, g_blk, d_blk, k_blk, *,
                 nf: int, n_blocks_f: int, state_reg: bool, use_defect: bool):
    """Launch the Riccati kernel.  Returns per-lane outputs (Mb, Nb, ...),
    dJ (Mb, 2) and fail (Mb,) int32."""
    Mb, Nb, n, nm = AB_blk.shape
    m = nm - n
    if n > MAX_N or m > MAX_M:
        raise ValueError(f"the Riccati kernel takes n <= {MAX_N}, m <= {MAX_M}; got n={n}, m={m}")
    build.check_input("rho", rho_l, (Mb,))
    build.check_input("seeds_P", seeds_P, (Mb, n, n))
    build.check_input("seeds_p", seeds_p, (Mb, n))
    build.check_input("AB_blk", AB_blk, (Mb, Nb, n, nm))
    build.check_input("H_blk", H_blk, (Mb, Nb, nm, nm))
    build.check_input("g_blk", g_blk, (Mb, Nb, nm))
    build.check_input("d_blk", d_blk, (Mb, Nb, n))
    build.check_input("k_blk", k_blk, (Mb, Nb), torch.int32)
    dev = AB_blk.device
    for t in (rho_l, seeds_P, seeds_p, H_blk, g_blk, d_blk, k_blk):
        if t.device != dev:
            raise ValueError("all Riccati inputs must be on one device")
    f32 = dict(device=dev, dtype=torch.float32)
    P = torch.empty((Mb, Nb, n, n), **f32)
    p = torch.empty((Mb, Nb, n), **f32)
    K = torch.empty((Mb, Nb, m, n), **f32)
    du = torch.empty((Mb, Nb, m), **f32)
    ApBK = torch.empty((Mb, Nb, n, n), **f32)
    Bdu = torch.empty((Mb, Nb, n), **f32)
    dj = torch.empty((Mb, 2), **f32)
    fail = torch.empty((Mb,), device=dev, dtype=torch.int32)
    lib = build.library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        status = lib.pddp_riccati(
            seeds_P.data_ptr(), seeds_p.data_ptr(), rho_l.data_ptr(),
            AB_blk.data_ptr(), H_blk.data_ptr(), g_blk.data_ptr(), d_blk.data_ptr(),
            k_blk.data_ptr(), P.data_ptr(), p.data_ptr(), K.data_ptr(), du.data_ptr(),
            ApBK.data_ptr(), Bdu.data_ptr(), dj.data_ptr(), fail.data_ptr(),
            Mb, Nb, n, m, nf, n_blocks_f, int(state_reg), int(use_defect), stream)
    build.check(status, "riccati")
    riccati_cuda.launches += 1
    return P, p, K, du, ApBK, Bdu, dj, fail


riccati_cuda.launches = 0


def make_riccati_block_call(cfg, n: int, m: int, mb: int | None = None):
    """Factory for the fused backward-sweep attempt (see the module
    docstring).  `mb` is the number of block lanes (default cfg.m_blocks_b).
    Raises if the plant is larger than the kernel's shared-memory sizing."""
    if n > MAX_N or m > MAX_M:
        raise ValueError(f"the Riccati kernel takes n <= {MAX_N}, m <= {MAX_M}; got n={n}, m={m}")
    Mb = cfg.m_blocks_b if mb is None else mb
    Nb = cfg.n_blocks_b
    nf = cfg.num_time_steps - 1
    use_defect = cfg.m_blocks_f > 1
    step = make_riccati_step(cfg, n, m)

    def bp(rho, seeds_P, seeds_p, AB_blk, H_blk, g_blk, d_blk, k_blk):
        dtype = AB_blk.dtype
        rho = torch.as_tensor(rho, dtype=dtype, device=AB_blk.device)
        flat = lambda a: a.reshape((Mb * Nb,) + a.shape[2:])
        if AB_blk.device.type == "cpu":
            P, p, K, du, ApBK, Bdu, dj, fail = run_block(
                step, rho.expand(Mb), seeds_P, seeds_p, AB_blk, H_blk, g_blk,
                d_blk, k_blk)
            return (flat(P), flat(p), flat(K), flat(du), flat(ApBK), flat(Bdu),
                    dj.sum(dim=(0, 1)), fail.any())
        P, p, K, du, ApBK, Bdu, dj, fail = riccati_cuda(
            rho.reshape(1).expand(Mb).contiguous(), seeds_P.contiguous(),
            seeds_p.contiguous(), AB_blk.contiguous(), H_blk.contiguous(),
            g_blk.contiguous(), d_blk.contiguous(),
            k_blk.to(torch.int32).contiguous(), nf=nf, n_blocks_f=cfg.n_blocks_f,
            state_reg=cfg.state_reg, use_defect=use_defect)
        return (flat(P), flat(p), flat(K), flat(du), flat(ApBK), flat(Bdu),
                dj.sum(dim=0), fail.any())

    return bp
