"""Seeded contract violations for ``kafka_tpu_torch.cli.programlint``
(port of ``tests/programlint_fixtures.py``): four fixture programs,
each violating exactly one checker's contract, registered in a private
REGISTRY the CLI loads via ``--spec-module
kafka_tpu_torch.testing.programlint_fixtures``.

``EXPECT`` maps each fixture to the one checker that must (and the only
checker that may) report it.
"""

from __future__ import annotations

from ..analysis.registry import BuiltProgram, register_program

#: fixture program -> the intended checker (and no other).
EXPECT = {
    "fixture_f64_upcast": "dtype",
    "fixture_smuggled_callback": "transfer",
    "fixture_rank3_relayout": "relayout",
    "fixture_unmanifested_collective": "collective",
}

REGISTRY = {}


def _state(device, *shape):
    import numpy as np
    import torch

    rng = np.random.default_rng(7)
    return torch.as_tensor(rng.uniform(0.1, 0.9, shape).astype(np.float32),
                           device=device)


@register_program(
    "fixture_f64_upcast",
    description="seeded violation: a mid-program float64 upcast of "
                "device data (run with float64 as the default dtype, "
                "the leak scenario the dtype checker guards)",
    x64=True,
    registry=REGISTRY,
)
def _build_f64(device):
    import torch

    def run(x):
        acc = x.to(torch.float64)          # the seeded upcast
        return (acc * acc).sum(dim=-1).to(torch.float32)

    return run, (_state(device, 64, 7),)


@register_program(
    "fixture_smuggled_callback",
    description="seeded violation: a host function smuggled into the "
                "program (.cpu().numpy() of device data, the result put "
                "back) — a host round-trip per execution",
    registry=REGISTRY,
)
def _build_callback(device):
    import numpy as np
    import torch

    def run(x):
        host = x.cpu().numpy()
        m = torch.as_tensor(np.mean(host, axis=-1, keepdims=True),
                            device=x.device)
        return x - m

    return run, (_state(device, 64, 7),)


@register_program(
    "fixture_rank3_relayout",
    description="seeded violation: a rank-3 Jacobian-shaped permute made "
                "dense (.permute(0, 2, 1).contiguous() on an (n, p, p) "
                "intermediate) in a program registered relayout_clean",
    relayout_clean=True,
    registry=REGISTRY,
)
def _build_relayout(device):
    def run(x):
        outer = x[:, :, None] * x[:, None, :]      # (n, p, p)
        # the (n, p, p) -> (n, p, p)^T relayout the in-kernel path
        # exists to delete.
        rows = outer.permute(0, 2, 1).contiguous()
        return rows.sum(dim=-1)

    return run, (_state(device, 64, 7),)


@register_program(
    "fixture_unmanifested_collective",
    description="seeded violation: a cross-pixel mean on a 2-shard "
                "pixel mesh that gathers every shard's partial sums "
                "(all_gather) where the manifest lists only all_reduce",
    collectives=("all_reduce",),
    registry=REGISTRY,
)
def _build_collective(device):
    import torch

    from ..core import collective
    from ..shard.mesh import make_pixel_mesh, split_pixels
    from ..shard.step import run_shards

    mesh = make_pixel_mesh([device] * 2)
    n = 128 * mesh.size

    def run(x):
        xs = split_pixels(mesh, x, 0)

        def one(k):
            parts = collective.all_gather(xs.shards[k].sum())
            return xs.shards[k] - torch.stack(parts).sum() / n

        return run_shards(mesh, one, n)

    return BuiltProgram(fn=run, args=(_state(device, n),),
                        mesh_devices=mesh.size)
