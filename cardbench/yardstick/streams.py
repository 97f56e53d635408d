"""Seeds, and a frozen copy of the program's CoCoA coordinate draw.

The window hands each solve the program's own index source
(``repro_torch.core.cocoa.UniformIndices``) with a seed of its own,
:func:`solve_seed`. :class:`UniformDraw` is that source's seeding and
draw as they stand, so that the reference and the metric readers draw
any round of any solve again without the program; a CPU test holds the
copy equal to the program's."""
from __future__ import annotations

import torch

_MASK = (1 << 64) - 1
# the program seeds round t's generator with seed * 1_000_003 + t, which
# has to stay under 2**64
SOLVE_SEED_BITS = 44


def splitmix64(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & _MASK
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK
    return x ^ (x >> 31)


def mix(*parts: int) -> int:
    """A 63-bit seed from whole numbers (each taken modulo 2**64)."""
    h = 0
    for p in parts:
        h = splitmix64(h ^ (int(p) & _MASK))
    return h & ((1 << 63) - 1)


def solve_seed(seed: int, i: int) -> int:
    """The index seed of solve ``i`` of a run with ``--seed`` ``seed``."""
    return mix(seed, i) & ((1 << SOLVE_SEED_BITS) - 1)


class UniformDraw:
    """``draw(t) -> (K, H) int32`` on ``device``: row k uniform over
    ``[0, sizes[k])``, from a ``torch.Generator`` seeded by
    ``seed * 1_000_003 + t`` (the program's ``UniformIndices``)."""

    def __init__(self, sizes, H: int, seed: int, device):
        self.sizes = torch.as_tensor([int(s) for s in sizes],
                                     dtype=torch.float32, device=device)
        self.H, self.seed, self.device = int(H), int(seed), device

    def __call__(self, t: int) -> torch.Tensor:
        g = torch.Generator(device=self.device)
        g.manual_seed(self.seed * 1_000_003 + int(t))
        u = torch.rand((self.sizes.shape[0], self.H), generator=g,
                       device=self.device)
        idx = torch.floor(u * self.sizes[:, None]).to(torch.int32)
        # u < 1, but u * size may round up to size in f32
        return torch.minimum(idx, (self.sizes[:, None] - 1).to(torch.int32))


def solve_draws(info: dict, op: dict, device) -> list:
    """Every round's (K, H) draw of a solve the run recorded (``op``),
    from the run's ``info`` (``sizes``, ``H``, ``seed``)."""
    draw = UniformDraw(info["sizes"], info["H"],
                       solve_seed(info["seed"], op["i"]), device)
    return [draw(t) for t in range(1, op["rounds"] + 1)]


def traced_draws(run) -> list:
    """Every round's draw of the solves a traced run profiled."""
    info = run.info
    return [idx for op in run.ops
            if op["i"] <= info.get("traced_solves", 0) and op.get("rounds")
            for idx in solve_draws(info, op, info["device"])]
