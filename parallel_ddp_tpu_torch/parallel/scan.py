"""Associative scan with `jax.lax.associative_scan`'s own pairing.

`associative_scan(fn, elems, dim=...)` computes the inclusive prefix
combination of `elems` along `dim` in O(log T) rounds of batched `fn` calls.
It is the recursion of JAX's `associative_scan` (its inner `_scan`), not a
Blelloch or Hillis-Steele scan:

  1. combine adjacent pairs, fn(e[0:-1:2], e[1::2]);
  2. scan that half-length sequence by recursion (the odd results);
  3. combine the odd results (all but the last when T is even) with
     e[2::2] (the even results), put e[0] in front, and interleave.

With `reverse=True` the inputs are flipped, scanned, and the results flipped
back, so `fn` receives (the combination of later elements, an earlier
element), as in JAX.  Each output element is built from the same pairs in
the same order as JAX's, so where `fn` rounds as its JAX twin does, the
results have the same float32 bits.

Plain PyTorch: a Python recursion over static lengths, so a CUDA graph
captures it as a fixed sequence of batched ops (about 2 log2 T calls of fn).
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch


def _take(t: torch.Tensor, dim: int, start: int, stop, step: int = 1) -> torch.Tensor:
    return t[(slice(None),) * dim + (slice(start, stop, step),)]


def _interleave(a: torch.Tensor, b: torch.Tensor, dim: int) -> torch.Tensor:
    """[a0, b0, a1, b1, ...] along dim; a has as many elements as b, or one more."""
    nb = b.shape[dim]
    pairs = torch.stack([_take(a, dim, 0, nb), b], dim=dim + 1).flatten(dim, dim + 1)
    if a.shape[dim] == nb:
        return pairs
    return torch.cat([pairs, _take(a, dim, nb, None)], dim=dim)


def _scan(fn, elems: tuple, dim: int) -> tuple:
    num = elems[0].shape[dim]
    if num < 2:
        return elems
    reduced = fn(tuple(_take(e, dim, 0, -1, 2) for e in elems),
                 tuple(_take(e, dim, 1, None, 2) for e in elems))
    odd = _scan(fn, tuple(reduced), dim)
    if num == 2:                          # e[2::2] is empty: nothing more to combine
        rest = tuple(_take(e, dim, 0, 0) for e in elems)
    elif num % 2 == 0:
        rest = fn(tuple(_take(o, dim, 0, -1) for o in odd),
                  tuple(_take(e, dim, 2, None, 2) for e in elems))
    else:
        rest = fn(odd, tuple(_take(e, dim, 2, None, 2) for e in elems))
    even = tuple(torch.cat([_take(e, dim, 0, 1), r], dim=dim) for e, r in zip(elems, rest))
    return tuple(_interleave(ev, od, dim) for ev, od in zip(even, odd))


def associative_scan(fn: Callable[[tuple, tuple], Sequence[torch.Tensor]],
                     elems: Sequence[torch.Tensor], *, dim: int,
                     reverse: bool = False) -> tuple:
    """Inclusive scan of `elems` (a tuple of tensors, all of one length along
    `dim`) under the associative fn(a, b) -> combined, where a and b are
    tuples like `elems` and a is the earlier part (for `reverse=True`, the
    later part: see the module docstring).  fn works elementwise over every
    other dim, as the leading scenario dims.  A negative `dim` counts from
    the end of the first tensor's dims and names the same position from the
    front in every tensor, as JAX's `axis`.  Returns a tuple like `elems`."""
    elems = tuple(elems)
    dim = dim % elems[0].dim()
    num = elems[0].shape[dim]
    if any(e.shape[dim] != num for e in elems):
        raise ValueError(f"associative_scan: lengths along dim {dim} differ: "
                         f"{[tuple(e.shape) for e in elems]}")
    if reverse:
        elems = tuple(e.flip(dim) for e in elems)
    out = _scan(fn, elems, dim)
    if reverse:
        out = tuple(o.flip(dim) for o in out)
    return out
