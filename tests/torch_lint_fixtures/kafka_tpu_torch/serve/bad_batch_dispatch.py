"""Seeded unbatched-serve-dispatch violations: launching a
solve around the batch executor (serve/batch.py) — the request never
meets its batch peers and the coalescing telemetry under-counts."""

from kafka_tpu_torch.core.solvers import assimilate_date_jit  # expect: unbatched-serve-dispatch


def serve_directly(session, date):
    return session.serve(date)  # expect: unbatched-serve-dispatch


def serve_smoothed_directly(session, date):
    return session.serve(date, smoothed=True)  # expect: unbatched-serve-dispatch


def dispatch_raw(linearize, obs, x, p_inv, aux, opts, hess):
    return assimilate_date_jit(  # expect: unbatched-serve-dispatch
        linearize, obs, x, p_inv, aux, opts, hess,
    )
