#!/usr/bin/env python3
"""Whether two checkouts' float32 rollout kernels (csrc/rollout.cu,
`kuka_rollout_cuda`) give the same bits, on an NVIDIA card.

    python3 scripts/torch_rollout_bits.py save ROOT OUT.pt   (ROOT: a checkout's root)
    python3 scripts/torch_rollout_bits.py compare A.pt B.pt

`save` imports the port from ROOT (building its kernels there), runs the
kernel on seeded inputs at six shapes (the WAFR shape 16 alphas x 4 blocks
x 16 steps with each integrator, 256 scenarios of it, 3 scenarios of 40
alphas x 2 x 16 RK3, 5 alphas x 3 x 7 midpoint) and saves the outputs;
`compare` prints, shape by shape, whether two such files are equal bit for
bit, and exits 1 where one is not.  Run both `save`s in one call on one
card, e.g. with the parent unpacked by `git archive` into a directory that
.gitignore lists.
"""

import pathlib
import sys

import numpy as np

SHAPES = (((), 16, 4, 16, 1), ((), 16, 4, 16, 2), ((), 16, 4, 16, 3),
          ((256,), 16, 4, 16, 1), ((3,), 40, 2, 16, 3), ((), 5, 3, 7, 2))


def save(root, out):
    sys.path.insert(0, str(pathlib.Path(root).resolve()))
    import torch

    from parallel_ddp_tpu_torch.ops import cuda_rollout

    here = pathlib.Path(cuda_rollout.__file__).resolve()
    assert here.is_relative_to(pathlib.Path(root).resolve()), f"imported {here}"
    dev = torch.device("cuda")
    f = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    outs = {}
    for lead, A, M, nf, integ in SHAPES:
        rng = np.random.default_rng(A * 100 + integ + len(lead))
        N = M * nf
        args = (f(rng.normal(0, 0.3, lead + (A, N, 14))), f(rng.normal(0, 1.0, lead + (N, 7))),
                f(rng.normal(0, 0.05, lead + (N, 7, 14))), f(rng.normal(0, 0.5, lead + (N, 7))),
                f(rng.normal(0, 0.3, lead + (N, 14))), f(0.5 ** np.arange(A)))
        skip = torch.zeros((M, nf), dtype=torch.uint8, device=dev)
        skip[-1, -1] = 1
        x, u = cuda_rollout.kuka_rollout_cuda(*args, skip, ee_type=1, gravity=0.0,
                                              integrator=integ, dt=0.5 / (N - 1), m_blocks=M)
        outs[f"{lead}-{A}-{M}-{nf}-{integ}"] = (x.cpu(), u.cpu())
    torch.save(outs, out)
    print(f"saved {len(outs)} shapes of {root}'s rollout kernel to {out}")


def compare(a, b):
    import torch

    ra, rb = torch.load(a), torch.load(b)
    ok = True
    for k in ra:
        same = all(torch.equal(p, q) for p, q in zip(ra[k], rb[k]))
        ok &= same
        print(k, "bit for bit" if same else "DIFFERS")
    print("float32 rollout kernel:", "identical" if ok else "DIFFERENT")
    return ok


if __name__ == "__main__":
    cmd, *rest = sys.argv[1:]
    if cmd == "save":
        save(*rest)
    elif not compare(*rest):
        sys.exit(1)
