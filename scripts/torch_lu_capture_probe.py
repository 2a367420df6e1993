#!/usr/bin/env python3
"""Which batched LU solves a CUDA graph captures, on the card.

The exact backward pass (`parallel/backward.py::_assoc_attempt`) solves
batches of small (14 x 14) systems inside the solver's captured body, where
no op may read the host.  For each form (`torch.linalg.solve_ex` with its
checks off, `lu_factor_ex` + `lu_solve`), each batch shape and a 14-column
or a 1-column right-hand side, this prints: torch's sync-debug count of an
eager call, whether a graph captures it at the top level and inside a WHILE
node (`graphs.while_loop`), whether the replay equals the eager call bit for
bit, the capture's nodes, and the eager ms at the path's batch sizes (CUDA
events over 50 calls).

Run on a machine with a CUDA card, from the root of a checkout:
    python3 scripts/torch_lu_capture_probe.py [solve_ex | lu_factor_ex+lu_solve]
A failed capture can leave the process's CUDA context unusable, so run one
form a process.
"""

import json
import os
import sys
import warnings

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

FORMS = {
    "solve_ex": lambda A, B: torch.linalg.solve_ex(A, B, check_errors=False)[0],
    "lu_factor_ex+lu_solve": lambda A, B: torch.linalg.lu_solve(
        *torch.linalg.lu_factor_ex(A, check_errors=False)[:2], B),
}
SHAPES = [(1,), (63,), (1023,), (3, 31), (2, 1), ()]
TIMED = ((63,), (1023,))


def main():
    from parallel_ddp_tpu_torch import graphs
    from parallel_ddp_tpu_torch.ops import build

    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(torch.__version__, torch.version.cuda, torch.cuda.get_device_name(0),
          "preferred linalg:", torch.backends.cuda.preferred_linalg_library(), flush=True)
    build.build()
    build.library()
    dev = torch.device("cuda:0")
    build.prepare_counters(dev)
    gen = torch.Generator().manual_seed(0)
    for name, f in FORMS.items():
        if sys.argv[1:] and name != sys.argv[1]:
            continue
        for shape in SHAPES:
            for cols in (14, 1):
                A = (torch.eye(14) + 0.3 * torch.randn(shape + (14, 14), generator=gen)).to(dev)
                B = torch.randn(shape + (14, cols), generator=gen).to(dev)
                row = {}
                try:
                    eager = f(A, B)
                    torch.cuda.synchronize()
                    with warnings.catch_warnings(record=True) as caught:
                        warnings.simplefilter("always")
                        torch.cuda.set_sync_debug_mode("warn")
                        f(A, B)
                        torch.cuda.set_sync_debug_mode(0)
                    row["eager_syncs"] = sum("synchroniz" in str(w.message) for w in caught)

                    def body_fn(A, B):
                        top = f(A, B)
                        out = torch.zeros_like(B)
                        trips = torch.zeros((), dtype=torch.int32, device=A.device)

                        def body(go):
                            out.copy_(f(A, B))
                            trips.add_(1)

                        graphs.while_loop(lambda: trips < 2, body, 2)
                        return top, out, trips

                    cap = graphs.Captured(body_fn, (A, B), "probe")
                    top, out, trips = cap(A, B)
                    torch.cuda.synchronize()
                    row.update(captured=True, while_trips=int(trips), nodes=cap.stats.nodes,
                               replay_equals_eager=bool(torch.equal(top, eager))
                               and bool(torch.equal(out, eager)))
                    if shape in TIMED:
                        start = torch.cuda.Event(enable_timing=True)
                        end = torch.cuda.Event(enable_timing=True)
                        for _ in range(3):
                            f(A, B)
                        torch.cuda.synchronize()
                        start.record()
                        for _ in range(50):
                            f(A, B)
                        end.record()
                        torch.cuda.synchronize()
                        row["eager_ms"] = start.elapsed_time(end) / 50
                except Exception as e:  # noqa: BLE001 - the finding is which forms fail
                    row.update(captured=False, error=f"{type(e).__name__}: {str(e)[:160]}")
                    torch.cuda.synchronize()
                print(f"{name} batch {shape} rhs columns {cols}: {json.dumps(row)}", flush=True)


if __name__ == "__main__":
    main()
