"""Counters of the hand-written kernels.

`LAUNCHES[name]` goes up by one each time a wrapper hands its work to the
CUDA library (and nowhere else): it counts wrapper CALLS that reached the
card. One such call enqueues several `<<<>>>` launches from its C entry
point; `DEVICE_LAUNCHES[name]` goes up by that number at the same place
(gsrb_relax: one per colour pass = 2 * nsweeps; residual: 1; tower_down:
2 * nsmooth per depth plus one residual-and-restrict per depth but the
last; tower_up: one prolongation plus 2 * nsmooth per depth above the
bottom — the loops of csrc/gsrb_relax.cu and csrc/tower.cu).
`PLAIN_CALLS[name]` goes up each time the plain PyTorch version of that
kernel runs. A run on the GPU can thereby show that its path went through
the kernels and never through a plain version.
"""

KERNELS = ("gsrb_relax", "residual", "tower_down", "tower_up")

LAUNCHES: dict[str, int] = {k: 0 for k in KERNELS}
DEVICE_LAUNCHES: dict[str, int] = {k: 0 for k in KERNELS}
PLAIN_CALLS: dict[str, int] = {k: 0 for k in KERNELS}


def count_launch(name: str, device_launches: int) -> None:
    """One wrapper call that enqueues `device_launches` kernel launches."""
    LAUNCHES[name] += 1
    DEVICE_LAUNCHES[name] += device_launches


def reset() -> None:
    for k in KERNELS:
        LAUNCHES[k] = 0
        DEVICE_LAUNCHES[k] = 0
        PLAIN_CALLS[k] = 0


def snapshot() -> dict:
    return {"launches": dict(LAUNCHES),
            "device_launches": dict(DEVICE_LAUNCHES),
            "plain_calls": dict(PLAIN_CALLS)}
