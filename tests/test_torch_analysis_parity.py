"""The port's program contracts held to the JAX package's
(``kafka_tpu/analysis``): the same registered programs with the same
``relayout_clean`` flags; ``fingerprint``, ``compare_manifest``,
``_census_diff`` and ``apply_waivers`` giving the JAX functions' results
on the same census dicts and findings (no JAX trace is needed: both
read only the census); and the programs that reach a hand kernel
exactly those whose checked-in JAX manifest counts a ``pallas_call`` —
with one stated exception, ``sharded_step_tip``, which the port runs on
the fused path (``fused_gn_shard``) while the JAX mesh program, with
``use_pallas`` unset, stays on XLA.
"""

import json
import os
import types

import pytest

import kafka_tpu.analysis as janalysis
import kafka_tpu.analysis.checkers as jcheckers
import kafka_tpu.analysis.programs  # noqa: F401  (registration)
from kafka_tpu_torch import analysis
from kafka_tpu_torch.analysis import checkers, programs

#: the port program that reaches a kernel where the JAX one does not.
KERNEL_EXCEPTION = "sharded_step_tip"


def _census(name="p", primitives=None, dtypes=None, host_syncs=None,
            kernels=None, collectives=None, callbacks=None,
            torch_version="2.13.0+cpu"):
    """A census both packages' functions read (duck-typed: they use the
    same attribute names)."""
    spec = types.SimpleNamespace(name=name, description="d",
                                 relayout_clean=False, collectives=())
    return types.SimpleNamespace(
        spec=spec, primitives=dict(primitives or {}),
        dtypes=dict(dtypes or {}), host_syncs=dict(host_syncs or {}),
        kernels=dict(kernels or {}), callbacks=dict(callbacks or {}),
        collectives=collectives, torch_version=torch_version)


CENSUSES = [
    _census(primitives={"aten.mul": 3, "aten.add": 1},
            dtypes={"float32": 4}),
    _census(primitives={"mul": 2, "exp": 9, "pjit": 1},
            dtypes={"float32": 11, "bool": 1}),
    _census(),
]


def _as_tuples(findings):
    return [(f.program, f.checker, f.message) for f in findings]


def test_registered_names_and_relayout_flags_equal_the_jax_registry():
    assert list(analysis.REGISTRY) == list(janalysis.REGISTRY)
    assert {n: s.relayout_clean for n, s in analysis.REGISTRY.items()} == \
        {n: s.relayout_clean for n, s in janalysis.REGISTRY.items()}
    assert {n for n, s in analysis.REGISTRY.items() if s.relayout_clean} \
        == {"date_twostream_inkernel", "windows_scan_twostream_inkernel"}


@pytest.mark.parametrize("k", range(len(CENSUSES)))
def test_fingerprint_is_the_jax_digest_without_reads_or_kernels(k):
    tp = CENSUSES[k]
    assert checkers.fingerprint(tp) == jcheckers.fingerprint(tp)


def test_fingerprint_hashes_host_reads_and_kernel_nodes():
    base = CENSUSES[0]
    with_reads = _census(primitives=base.primitives, dtypes=base.dtypes,
                         host_syncs={"aten._local_scalar_dense": 1})
    with_kernel = _census(primitives=base.primitives, dtypes=base.dtypes,
                          kernels={"fused_gn": 1})
    digests = {checkers.fingerprint(t)
               for t in (base, with_reads, with_kernel)}
    assert len(digests) == 3
    assert checkers.fingerprint(base) == jcheckers.fingerprint(with_reads)


DIFF_CASES = [
    ({}, {}),
    ({"a": 1}, {"a": 1}),
    ({"a": 1, "b": 2}, {"a": 3, "c": 4}),
    ({f"op{i}": i for i in range(10)}, {f"op{i}": i + 1 for i in range(10)}),
]


@pytest.mark.parametrize("old,new", DIFF_CASES)
def test_census_diff_equals_the_jax_one(old, new):
    assert checkers._census_diff(old, new) == \
        jcheckers._census_diff(old, new)
    assert checkers._census_diff(old, new, limit=2) == \
        jcheckers._census_diff(old, new, limit=2)


def _stored(tp, **over):
    return {"fingerprint": checkers.fingerprint(tp),
            "primitives": dict(tp.primitives), "collectives": None,
            "torch": tp.torch_version, **over}


@pytest.mark.parametrize("case", ["missing", "same", "drift", "collective"])
def test_compare_manifest_gives_the_jax_findings(case):
    tp = CENSUSES[0]
    stored = {"missing": None, "same": _stored(tp),
              "drift": _stored(tp, fingerprint="0" * 16,
                               primitives={"aten.mul": 2}),
              "collective": _stored(tp, collectives={"all_reduce": 1})}[case]
    if case == "collective":
        tp = _census(primitives=tp.primitives, dtypes=tp.dtypes,
                     collectives={"all_reduce": 2})
    port = checkers.compare_manifest(tp, stored)
    ref = jcheckers.compare_manifest(tp, stored)
    assert [(f.program, f.checker) for f in port] == \
        [(f.program, f.checker) for f in ref]
    for p, r in zip(port, ref):
        if p.checker == "drift" and "fingerprint" in p.message:
            # the same digests and the same deltas; the command differs
            head = r.message.split(" — ")[0].replace("trace fingerprint",
                                                     "census fingerprint")
            assert p.message.split(" — ")[0] == head
        elif p.checker == "drift":
            assert p.message.split(" — ")[0] == r.message.split(" — ")[0]


WAIVER_CASES = [
    ([], []),
    ([("drift", "x drifted a -> b")],
     [{"checker": "drift", "contains": "drifted", "reason": "r"}]),
    ([("transfer", "'numpy' appears"), ("dtype", "float64 appears")],
     [{"checker": "dtype", "contains": "float64", "reason": "r"},
      {"checker": "relayout", "contains": "gone", "reason": "stale"}]),
    ([("dtype", "float64 appears")], [{"checker": "dtype", "reason": "any"}]),
]


@pytest.mark.parametrize("found,waivers", WAIVER_CASES)
def test_apply_waivers_equals_the_jax_one(found, waivers):
    port = [checkers.ContractFinding("p", c, m) for c, m in found]
    ref = [jcheckers.ContractFinding("p", c, m) for c, m in found]
    assert _as_tuples(checkers.apply_waivers(port, waivers, "p")) == \
        _as_tuples(jcheckers.apply_waivers(ref, waivers, "p"))


def test_finding_format_equals_the_jax_one():
    f = ("prog", "dtype", "message")
    assert checkers.ContractFinding(*f).format() == \
        jcheckers.ContractFinding(*f).format()


def _jax_manifest(name):
    path = os.path.join(janalysis.contracts_dir(), f"{name}.json")
    with open(path) as fh:
        return json.load(fh)


def test_kernel_bearing_programs_are_the_jax_pallas_programs():
    """Read from both packages' checked-in manifests: the port programs
    with a kernel node are those whose JAX census holds a pallas_call,
    plus the stated exception."""
    jax_pallas = {n for n in janalysis.REGISTRY
                  if _jax_manifest(n)["primitives"].get("pallas_call")}
    port_kernels = {n for n in analysis.REGISTRY
                    if checkers.load_manifest(analysis.contracts_dir(),
                                              n)["kernels"]}
    assert jax_pallas == {"date_twostream_inkernel",
                          "date_twostream_jac_to_rows",
                          "windows_scan_twostream_inkernel"}
    assert port_kernels == jax_pallas | {KERNEL_EXCEPTION}
    assert not _jax_manifest(KERNEL_EXCEPTION)["primitives"].get(
        "pallas_call")


def test_mesh_manifests_keep_the_jax_collective_contract():
    """The JAX mesh step permits one all-reduce and its forward none; the
    port's step adds the all_gather of the groups straddling shards
    (``core.fused_gn.fused_gn_shard``), its forward still none."""
    jstep = _jax_manifest("sharded_step_tip")
    assert set(jstep["collectives_manifest"]) == {"all-reduce"}
    step = checkers.load_manifest(analysis.contracts_dir(),
                                  "sharded_step_tip")
    assert step["collectives_manifest"] == ["all_gather", "all_reduce"]
    assert step["mesh_devices"] == programs.MESH_SHARDS
    fwd = checkers.load_manifest(analysis.contracts_dir(),
                                 "sharded_forward_tip")
    assert fwd["collectives"] == {} and fwd["collectives_manifest"] == []
    assert _jax_manifest("sharded_forward_tip")["collectives"] == {}


def test_descriptions_name_the_same_programs():
    """Each description keeps the JAX one's subject (its first words up
    to the comma or colon name the entry point or operator)."""
    for name, spec in analysis.REGISTRY.items():
        jdesc = janalysis.REGISTRY[name].description
        subject = jdesc.split(",")[0].split(":")[0].split(" (")[0]
        subject = subject.replace("_jit", "").replace("_rts_sweep",
                                                       "rts_sweep")
        if name.startswith("smoother"):
            subject = "rts_sweep"
        assert subject.split()[0] in spec.description, (name, subject)
