"""Canonical seeded programs for every production device program (port
of ``kafka_tpu/analysis/programs.py``).

Each builder reconstructs one real entry point exactly as the engine
calls it and pairs it with concrete arguments of canonical (small but
structurally representative) shapes, made from a seed on the program's
device: ``N_PIX`` pixels of the TIP problem (``TIP_P`` parameters,
``TIP_BANDS`` bands) from ``testing.synthetic``.  An eager program's
loop reads its convergence test on the host, so a census would follow
the data; every solve whose loop runs on the host therefore pins its
trip count with ``PIN``: ``tol: 0.0`` (no step norm is below 0, so the
loop runs its ``max_iterations + 1`` steps on any device and any data)
and ``max_iterations: 2``, three steps where the JAX specs (traced
abstractly, a loop body once) ask for 5: each step repeats the same
operators, so three show every one of them at half the cost.  The
in-kernel programs keep the JAX options: their loop runs inside one
``fused_gn`` node, and its trips do not reach the census.

``COVERED_ENTRY_POINTS`` is the AST-readable twin of the registry: every
def in the port's device packages that launches a hand kernel
(``core._build.count_launch``) or enters a kernel region
(``core._build.kernel_region``) must be listed here
(``tests/test_torch_programlint.py`` scans for them), and each name is
reached by a registered program — ``solve_rows`` excepted (below).
"""

from __future__ import annotations

from .registry import BuiltProgram, register_program

#: defs whose calls the registered programs below run (parsed by the
#: coverage test as a literal).
COVERED_ENTRY_POINTS = {
    # core/solvers.py — the per-date solve, its coalesced-serving twin
    # (K members on a leading axis) and the fused window scan.
    "assimilate_date",
    "assimilate_date_batch",
    "assimilate_windows_scan",
    # core/fused_gn.py, core/fused_update.py, core/solve_rows.py — the
    # hand kernels' wrappers (kernel regions) and launch sites
    # (``_launch_cuda`` in each module).  ``solve_rows`` is named though
    # no engine path reaches it (PERF.md §6: its own path is
    # ``solve_spd_packed_kernel``), as the JAX set names its Pallas
    # counterpart.
    "fused_gn_rows",
    "fused_gn_raw",
    "fused_gn_shard",
    "fused_update_rows",
    "solve_rows",
    "_launch_cuda",
    # smoother/rts_pass.py — the reverse RTS sweep.
    "rts_sweep",
    # shard/step.py — the mesh-partitioned per-date step and forward.
    "make_sharded_step",
    "make_sharded_forward",
}

#: canonical batch shapes: small enough to run in well under a second on
#: the CPU, large enough that nothing degenerates (multi-band, p > 4).
N_PIX = 256
TIP_P = 7
TIP_BANDS = 2
#: the options every solve whose loop runs on the host takes: the
#: trip-count pin (3 steps).
PIN = {"tol": 0.0, "max_iterations": 2}
#: shards of the mesh programs (one thread each, on the program's
#: device).
MESH_SHARDS = 2


def _tip_batch(device, n_pix=N_PIX, k_windows=None, seed=0):
    """A seeded TIP problem on ``device``: ``(operator, obs, x, p_inv)``,
    the observations with a leading window axis when ``k_windows`` is
    given (each window its own draw), the prior made contiguous."""
    import torch

    from ..core.types import BandBatch
    from ..testing.synthetic import make_tip_problem

    if k_windows is None:
        op, obs, x0, p_inv0 = make_tip_problem(n_pix, seed=seed,
                                               device=device)
    else:
        draws = [make_tip_problem(n_pix, seed=seed + k, device=device)
                 for k in range(k_windows)]
        op, _, x0, p_inv0 = draws[0]
        obs = BandBatch(*(torch.stack([d[1][i] for d in draws])
                          for i in range(3)))
    return op, obs, x0.contiguous(), p_inv0.contiguous()


def _date_program(solver_options, device, n_pix=N_PIX):
    from ..core.solvers import assimilate_date

    op, obs, x, p_inv = _tip_batch(device, n_pix)

    def run(obs, x, p_inv):
        return assimilate_date(op.linearize, obs, x, p_inv, None,
                               dict(solver_options), device=device)

    return run, (obs, x, p_inv)


@register_program(
    "date_twostream_xla",
    description="assimilate_date, plain path (two-stream TIP, "
                "out-of-kernel linearize + packed solve in torch; "
                "use_pallas False; PIN: 3 steps)",
)
def _build_date_xla(device, n_pix=N_PIX):
    return _date_program({"use_pallas": False, **PIN}, device, n_pix)


@register_program(
    "date_twostream_inkernel",
    description="assimilate_date, fused in-kernel path (the whole GN "
                "loop in one fused_gn launch; the flagship perf "
                "program)",
    relayout_clean=True,
)
def _build_date_inkernel(device, n_pix=N_PIX):
    return _date_program({
        "use_pallas": True, "inkernel_linearize": True,
        "min_iterations": 2, "max_iterations": 5,
    }, device, n_pix)


@register_program(
    "date_twostream_jac_to_rows",
    description="assimilate_date, fused-update path through the "
                "sanctioned jac_to_rows relayout shim (out-of-kernel "
                "linearize feeding one fused_update launch per step; "
                "PIN: 3 steps)",
)
def _build_date_jac_to_rows(device, n_pix=N_PIX):
    return _date_program({
        "use_pallas": True, "inkernel_linearize": False, **PIN,
    }, device, n_pix)


@register_program(
    "date_batched_twostream_xla",
    description="assimilate_date_batch: K=4 coalesced serve members "
                "(a leading member axis; each member's slice the bits "
                "of a solo date solve; the stacked options are host "
                "tensors; PIN: 3 steps)",
)
def _build_date_batched_xla(device):
    import torch

    from ..core.solvers import assimilate_date_batch, stack_solver_options
    from ..core.types import BandBatch

    k = 4
    draws = [_tip_batch(device, seed=m) for m in range(k)]
    op = draws[0][0]
    obs = BandBatch(*(torch.stack([d[1][i] for d in draws])
                      for i in range(3)))
    x = torch.stack([d[2] for d in draws])
    p_inv = torch.stack([d[3] for d in draws])
    # Per-member numeric leaves stack to (K,) exactly as the serving
    # executor's stack_solver_options produces them.
    opts = stack_solver_options([
        {"use_pallas": False, "norm_denominator": float(N_PIX * (1 + i)),
         **PIN}
        for i in range(k)
    ])

    def run(obs, x, p_inv):
        return assimilate_date_batch(op.linearize, obs, x, p_inv, None,
                                     opts, device=device)

    return run, (obs, x, p_inv)


def _scan_program(solver_options, device, k_windows=3):
    from ..core.solvers import assimilate_windows_scan

    op, obs, x, p_inv = _tip_batch(device, k_windows=k_windows)
    prior_mean, prior_inv = x.clone(), p_inv.clone()

    def run(obs, x, p_inv, prior_mean, prior_inv):
        return assimilate_windows_scan(
            op.linearize, obs, x, p_inv,
            prior_mean=prior_mean, prior_inv=prior_inv,
            solver_options=dict(solver_options),
        )

    return run, (obs, x, p_inv, prior_mean, prior_inv)


@register_program(
    "windows_scan_twostream",
    description="assimilate_windows_scan, plain path: K=3 advance+solve "
                "windows in one call (prior-only advance, the engine's "
                "temporal-fusion dispatch; PIN: 3 steps a window)",
)
def _build_scan_xla(device):
    return _scan_program({"use_pallas": False, **PIN}, device)


@register_program(
    "windows_scan_twostream_inkernel",
    description="assimilate_windows_scan with the fused in-kernel solve "
                "(one fused_gn launch) inside each window",
    relayout_clean=True,
)
def _build_scan_inkernel(device):
    return _scan_program({
        "use_pallas": True, "inkernel_linearize": True,
        "min_iterations": 2, "max_iterations": 5,
    }, device)


@register_program(
    "smoother_rts_sweep",
    description="the smoother's reverse sweep (rts_sweep): fixed-"
                "interval RTS recursion over T=4 checkpoints",
)
def _build_rts_sweep(device):
    import numpy as np
    import torch

    from ..smoother.rts_pass import rts_sweep

    n, p, t = 64, TIP_P, 4
    rng = np.random.default_rng(4)

    def spd(*lead):
        a = rng.normal(0.0, 0.3, lead + (p, p))
        return np.einsum("...ij,...kj->...ik", a, a) + 2.0 * np.eye(p)

    def put(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    args = (
        put(rng.uniform(0.1, 0.9, (t - 1, n, p))), put(spd(t - 1, n)),
        put(rng.uniform(0.1, 0.9, (t - 1, n, p))), put(spd(t - 1, n)),
        put(np.eye(p)), put(rng.uniform(0.1, 0.9, (n, p))), put(spd(n)),
    )
    return rts_sweep, args


# ---------------------------------------------------------------------------
# Operator linearizations: one program per operator family, running the
# exact ``linearize`` the solver calls.
# ---------------------------------------------------------------------------

def _state(device, n_params, n_pix=N_PIX, seed=1):
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    return torch.as_tensor(
        rng.uniform(0.2, 0.8, (n_pix, n_params)).astype(np.float32),
        device=device)


def _angles(device):
    import torch

    from ..obsops.prosail import ProsailAux

    return ProsailAux(*(torch.tensor(v, dtype=torch.float32, device=device)
                        for v in (30.0, 5.0, 90.0)))


def _theta(device):
    import numpy as np
    import torch

    from ..obsops.wcm import WCMAux

    rng = np.random.default_rng(3)
    return WCMAux(theta_deg=torch.as_tensor(
        rng.uniform(30.0, 45.0, N_PIX).astype(np.float32), device=device))


@register_program(
    "linearize_twostream",
    description="TwoStreamOperator.linearize (2-band TIP, aux=None)",
)
def _build_lin_twostream(device):
    from ..obsops.twostream import TwoStreamOperator

    op = TwoStreamOperator()
    return (lambda x: op.linearize(None, x)), (_state(device, TIP_P),)


@register_program(
    "linearize_prosail",
    description="ProsailOperator.linearize (10-band S2 reflectance, "
                "scalar acquisition geometry aux)",
)
def _build_lin_prosail(device):
    from ..obsops.prosail import ProsailOperator

    op = ProsailOperator()
    return op.linearize, (_angles(device), _state(device, 10))


@register_program(
    "linearize_gp_bank",
    description="GPBankOperator.linearize (banked GP emulators, leading "
                "band axis on every GPParams leaf)",
)
def _build_lin_gp_bank(device):
    import numpy as np
    import torch

    from ..obsops.gp import GPBankOperator, GPParams

    m = 32  # inducing points per band
    rng = np.random.default_rng(5)

    def put(*shape, lo=-1.0, hi=1.0):
        return torch.as_tensor(rng.uniform(lo, hi, shape).astype(
            np.float32), device=device)

    op = GPBankOperator(n_params=TIP_P, n_bands=TIP_BANDS)
    aux = GPParams(
        x_train=put(TIP_BANDS, m, TIP_P, lo=0.0),
        alpha=put(TIP_BANDS, m),
        log_lengthscales=put(TIP_BANDS, TIP_P, lo=-0.5, hi=0.5),
        log_amplitude=put(TIP_BANDS, lo=-0.5, hi=0.5),
        y_mean=put(TIP_BANDS, lo=0.0),
    )
    return op.linearize, (aux, _state(device, TIP_P))


@register_program(
    "linearize_mlp",
    description="MLPOperator.linearize (surrogate MLP, params via aux)",
)
def _build_lin_mlp(device):
    import numpy as np
    import torch

    from ..obsops.mlp import MLPOperator

    hidden = 16
    rng = np.random.default_rng(6)
    op = MLPOperator(n_params=TIP_P, n_bands=3)

    def put(*shape):
        return torch.as_tensor(rng.normal(0.0, 0.5, shape).astype(
            np.float32), device=device)

    aux = [{"w": put(TIP_P, hidden), "b": put(hidden)},
           {"w": put(hidden, 3), "b": put(3)}]
    return op.linearize, (aux, _state(device, TIP_P))


@register_program(
    "linearize_wcm",
    description="WCMOperator.linearize (dual-pol water-cloud model, "
                "per-pixel incidence-angle aux)",
)
def _build_lin_wcm(device):
    from ..obsops.wcm import WCMOperator

    op = WCMOperator()
    return op.linearize, (_theta(device), _state(device, op.n_params))


@register_program(
    "linearize_joint_optical",
    description="ProsailJointOperator.linearize (11-param joint state, "
                "optical constraint)",
)
def _build_lin_joint_optical(device):
    from ..obsops.joint import ProsailJointOperator

    op = ProsailJointOperator()
    return op.linearize, (_angles(device), _state(device, op.n_params))


@register_program(
    "linearize_joint_sar",
    description="WCMJointOperator.linearize (11-param joint state, SAR "
                "constraint through the transformed-LAI decode)",
)
def _build_lin_joint_sar(device):
    from ..obsops.joint import WCMJointOperator

    op = WCMJointOperator()
    return op.linearize, (_theta(device), _state(device, op.n_params))


# ---------------------------------------------------------------------------
# Mesh programs: run on a pixel mesh of MESH_SHARDS shards of the
# program's device (one thread per shard), with the shards' collective
# calls checked against an explicit manifest.
# ---------------------------------------------------------------------------

@register_program(
    "sharded_step_tip",
    description="make_sharded_step: the pixel-sharded per-date "
                "advance+solve (one thread per shard; the fused path, "
                "so fused_gn_shard: the trip count and the scalar "
                "convergence norm are combined by all_reduce, and the "
                "convergence groups that straddle shards are gathered to "
                "the first shard, launched once and handed back by "
                "all_gather)",
    collectives=("all_reduce", "all_gather"),
)
def _build_sharded_step(device):
    import torch

    from ..shard.mesh import make_pixel_mesh, pad_for_mesh
    from ..shard.step import make_sharded_step

    mesh = make_pixel_mesh([device] * MESH_SHARDS)
    n = pad_for_mesh(N_PIX, mesh)
    op, obs, x, p_inv = _tip_batch(device, n)
    step = make_sharded_step(
        op.linearize, mesh, solver_options={"max_iterations": 5},
        n_valid=N_PIX,
    )
    args = (
        obs, x, p_inv, torch.eye(TIP_P, device=device),
        torch.full((TIP_P,), 1e-3, device=device), x.clone(), p_inv.clone(),
        None,
    )
    return BuiltProgram(fn=step, args=args, mesh_devices=mesh.size)


@register_program(
    "sharded_forward_tip",
    description="make_sharded_forward: the pixel-sharded batched "
                "forward (prediction path) — zero collectives permitted",
    collectives=(),
)
def _build_sharded_forward(device):
    from ..obsops.twostream import TwoStreamOperator
    from ..shard.mesh import make_pixel_mesh, pad_for_mesh
    from ..shard.step import make_sharded_forward

    mesh = make_pixel_mesh([device] * MESH_SHARDS)
    n = pad_for_mesh(N_PIX, mesh)
    op = TwoStreamOperator()
    fwd = make_sharded_forward(op.forward, mesh)
    return BuiltProgram(
        fn=fwd, args=(None, _state(device, TIP_P, n)),
        mesh_devices=mesh.size,
    )
