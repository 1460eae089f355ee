"""Counters of the hand-written kernels.

`LAUNCHES[name]` goes up by one each time a wrapper hands its work to the
CUDA library (and nowhere else): it counts wrapper CALLS that reached the
card. `DEVICE_LAUNCHES[name]` goes up, at the same place, by the number of
kernel launches that call enqueued from its C entry point: 1 for every
kernel — gsrb_relax, all its sweeps in one cooperative launch (csrc/
gsrb_relax.cu); gsrb_full_sweep and gsrb_half_sweep, the one-sweep and
one-pass entry points, each one launch out of place (csrc/gsrb_sweep.cu, or
gsrb_relax's grid form for a full sweep where the march does not apply),
counted under their own names; residual and residual_restrict, the two forms of one march
(csrc/residual.cu: the residual whole, or restricted by full weighting in
the same launch); tower_down and tower_up, each a whole depth chain in one
cooperative launch (csrc/tower.cu); wavefront_relax and multisweep_relax,
two wrappers of one kernel, and multisweep_relax_halo /
multisweep_relax_tiled_pre, the same march on one shard of a sharded level
(an x-slab with its pads, a prepadded pencil), all passes of the chunk in
one launch (csrc/multisweep.cu, csrc/multisweep_halo.cu);
gsrb_relax_batch and residual_restrict_batch, the batched forms of
gsrb_relax and residual_restrict (the same kernels: the same-shape sibling
patches of a batch group in one launch, up to fused_sweeps.BATCH_MAX);
gsrb_relax_batch_march, the launches of fused_sweeps.gsrb_relax_batch that
take its batch march (csrc/gsrb_batch_march.cu: a group whose patches
overflow the L2), counted apart from the batched gsrb_relax's (the plain
version of both is gsrb_relax_batch's);
gsrb_relax_bf16, tower_down_bf16, tower_up_bf16, wavefront_relax_bf16,
multisweep_relax_bf16, multisweep_relax_halo_bf16 and
multisweep_relax_tiled_pre_bf16, the same kernels in the bf16 tier
(smoother_precision = bfloat16: their colour passes in bf16), counted apart
so that a run shows where the tier ran and where not.
`PLAIN_CALLS[name]` goes up each time the plain PyTorch version of that
kernel runs. A run on the GPU can thereby show that its path went through
the kernels and never through a plain version.

`HALO[name]` counts what the sharded path copies (parallel/shards.py says
what each name counts): level splits and joins, level windows,
coefficient splits, joins and pad builds, pad exchanges, the moves of a
batch group's patches to the mesh positions that compute them and back
(patch_moves), and the bytes
moved between mesh positions, and over several processes the bytes and
messages that crossed between processes (parallel/transport.py). Over
several processes each event is counted once, by process 0, and each copy
by the process that owns its destination, so that the counts of all
processes add up to those of one process driving the same mesh.
"""

KERNELS = ("gsrb_relax", "residual", "residual_restrict", "tower_down",
           "tower_up", "wavefront_relax", "multisweep_relax",
           "multisweep_relax_halo", "multisweep_relax_tiled_pre",
           "gsrb_relax_batch", "gsrb_relax_batch_march",
           "residual_restrict_batch", "gsrb_relax_bf16",
           "tower_down_bf16", "tower_up_bf16", "wavefront_relax_bf16",
           "multisweep_relax_bf16", "multisweep_relax_halo_bf16",
           "multisweep_relax_tiled_pre_bf16", "gsrb_full_sweep",
           "gsrb_half_sweep")

LAUNCHES: dict[str, int] = {k: 0 for k in KERNELS}
DEVICE_LAUNCHES: dict[str, int] = {k: 0 for k in KERNELS}
PLAIN_CALLS: dict[str, int] = {k: 0 for k in KERNELS}
HALO_COUNTS = ("level_splits", "level_joins", "level_windows",
               "coef_splits", "coef_joins", "coef_pad_builds",
               "pad_exchanges", "patch_moves", "bytes_moved", "bytes_between_processes",
               "messages")
HALO: dict[str, int] = {k: 0 for k in HALO_COUNTS}


def count_launch(name: str, device_launches: int) -> None:
    """One wrapper call that enqueues `device_launches` kernel launches."""
    LAUNCHES[name] += 1
    DEVICE_LAUNCHES[name] += device_launches


def reset() -> None:
    for k in KERNELS:
        LAUNCHES[k] = 0
        DEVICE_LAUNCHES[k] = 0
        PLAIN_CALLS[k] = 0
    for k in HALO_COUNTS:
        HALO[k] = 0


def snapshot() -> dict:
    return {"launches": dict(LAUNCHES),
            "device_launches": dict(DEVICE_LAUNCHES),
            "plain_calls": dict(PLAIN_CALLS), "halo": dict(HALO)}
