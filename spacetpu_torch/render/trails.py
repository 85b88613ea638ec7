"""Trail history: the ring buffer of recent positions (PyTorch).

The counterpart of `spacetpu/render/trails.py`: a dense (T, N, 3) tensor on
the renderer's device and a write cursor. The cursor and the count live on
the host as Python ints, so `push`, `ages` and `latest` never read the
device back. `push` writes the snapshot into the history in place (the JAX
version returns a new array); the returned `TrailBuffer` shares the
history tensor of its argument.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from spacetpu_torch.constants import TRAIL_MAX_LENGTH


class TrailBuffer(NamedTuple):
    """Ring buffer state. `history[k]` is a snapshot; `head` is the slot the
    *next* push writes; `count` saturates at T (how many slots are valid)."""

    history: torch.Tensor  # (T, N, 3)
    head: int
    count: int

    @property
    def capacity(self) -> int:
        return self.history.shape[0]


def make_trails(n: int, t: int = TRAIL_MAX_LENGTH, dtype=torch.float32, *,
                device=None) -> TrailBuffer:
    """An empty buffer of `t` snapshots of `n` bodies on `device` (the CPU
    when None: the caller names the renderer's device)."""
    return TrailBuffer(
        history=torch.zeros((t, n, 3), dtype=dtype, device=device),
        head=0, count=0)


def push(tb: TrailBuffer, pos) -> TrailBuffer:
    """Append one position snapshot, overwriting the oldest when full.
    `pos` is an (N, 3) tensor or array, copied into the history's device
    and dtype."""
    pos = torch.as_tensor(pos)
    tb.history[tb.head].copy_(pos, non_blocking=False)
    return TrailBuffer(history=tb.history, head=(tb.head + 1) % tb.capacity,
                       count=min(tb.count + 1, tb.capacity))


def clear(tb: TrailBuffer) -> TrailBuffer:
    """Reset: a new zeroed history (the space-key trail clear)."""
    return TrailBuffer(history=torch.zeros_like(tb.history), head=0, count=0)


def ages(tb: TrailBuffer) -> torch.Tensor:
    """(T,) age of each slot in [0, 1], in the history's dtype and on its
    device: 0 = newest snapshot, 1 = oldest valid; invalid slots get 2
    (the renderer fades alpha with age)."""
    t = tb.capacity
    slot = torch.arange(t, device=tb.history.device)
    age_steps = ((tb.head - 1) % t - slot) % t  # 0 newest .. t-1 oldest
    denom = max(tb.count - 1, 1)
    return torch.where(age_steps < tb.count,
                       age_steps.to(tb.history.dtype) / denom,
                       torch.full((), 2.0, dtype=tb.history.dtype,
                                  device=tb.history.device))


def latest(tb: TrailBuffer) -> torch.Tensor:
    """The most recent snapshot."""
    return tb.history[(tb.head - 1) % tb.capacity]
