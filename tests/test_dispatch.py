"""The platform rule (tpu_ntt.dispatch.select_plan): every benchmark cell
on each platform, and the errors that keep a missing device visible."""

import pytest

import bench
from tpu_ntt.dispatch import current_platform, select_plan

# plan kind of each cell: (on the CPU, on a GPU)
CELL_KINDS = {
    "sw256": ("xla", "fused"),
    "hw256": ("xla", "fused"),
    "hw256cyc": ("xla", "fused"),
    "dilithium256": ("xla", "fused"),
    "kyber": ("incomplete", "fused-incomplete"),
    "kyber_matvec": ("incomplete", "fused-incomplete"),
    "dilithium_matvec": ("xla", "fused"),
    "large": ("fourstep", "fourstep"),
    "large23": ("fourstep", "fourstep"),
    "xlarge": ("fourstep", "fourstep"),
    "bigq62": ("bigq", "bigq"),
    "bigq64": ("bigq", "bigq"),
    "bigq65536": ("bigq", "bigq"),
    "bigq1m": ("bigq", "bigq"),
}


def _ring(config):
    """(n, q, negacyclic) of a benchmark cell."""
    if config == "kyber_matvec":
        return 256, 3329, True
    if config == "dilithium_matvec":
        config = "dilithium256"
    p = bench._params(config, rehearse=False)
    return (256, 3329, True) if p is None else (p.n, p.q, p.negacyclic)


def test_cell_table_covers_the_benchmark():
    assert set(CELL_KINDS) == set(bench.CELLS)


@pytest.mark.parametrize("platform", ["cpu", "gpu"])
@pytest.mark.parametrize("config", sorted(CELL_KINDS))
def test_select_plan_per_cell(config, platform):
    n, q, negacyclic = _ring(config)
    want = CELL_KINDS[config][platform == "gpu"]
    assert select_plan(n, q, negacyclic, platform=platform) == want


@pytest.mark.parametrize("platform", ["rocm", "METAL", "neuron"])
def test_unknown_platform_raises(platform):
    with pytest.raises(RuntimeError, match="unsupported platform"):
        select_plan(256, 12289, platform=platform)


def test_current_platform_refuses_other_backends(monkeypatch):
    import jax
    assert current_platform() == "cpu"
    monkeypatch.setattr(jax, "default_backend", lambda: "rocm")
    with pytest.raises(RuntimeError, match="unsupported platform"):
        current_platform()


def test_pallas_without_gpu_raises():
    """backend='pallas' never falls back to the interpreter: without a GPU
    it raises, from the rule and from every entry point."""
    from tpu_ntt.ring import Ring
    from tpu_ntt.schemes import kyber_plan
    with pytest.raises(RuntimeError, match="needs a GPU"):
        select_plan(256, 12289, backend="pallas", platform="cpu")
    with pytest.raises(RuntimeError, match="needs a GPU"):
        Ring(256, 12289, backend="pallas")
    with pytest.raises(RuntimeError, match="needs a GPU"):
        kyber_plan(backend="pallas")


@pytest.mark.parametrize("backend,kind", [("pallas", "fused"),
                                          ("xla", "xla"),
                                          ("matmul", "matmul")])
def test_explicit_backend_on_gpu(backend, kind):
    assert select_plan(256, 12289, backend=backend, platform="gpu") == kind


def test_mesh_and_bad_backend():
    from tpu_ntt.parallel.sharded import make_mesh
    mesh = make_mesh(2)
    assert select_plan(1024, 12289, mesh=mesh, platform="gpu") == "sharded"
    assert select_plan(256, (1 << 61) - 1, mesh=mesh) == "bigq"
    with pytest.raises(ValueError, match="backend must be"):
        select_plan(256, 12289, backend="mxu")
    with pytest.raises(NotImplementedError, match="negacyclic-only"):
        select_plan(256, (1 << 61) - 1, negacyclic=False)


def _cls(path):
    import importlib
    mod, name = path.rsplit(".", 1)
    return getattr(importlib.import_module(mod), name)


@pytest.mark.parametrize("n,q,negacyclic,backend,kind,cls", [
    (256, 12289, True, "auto", "xla", "tpu_ntt.transform.Plan"),
    (256, 7681, False, "auto", "xla", "tpu_ntt.transform.Plan"),
    (256, 3329, True, "auto", "incomplete", "tpu_ntt.schemes.IncompletePlan"),
    (256, 12289, True, "matmul", "matmul", "tpu_ntt.ops.matmul_ntt.MatmulNTT"),
    (16384, 65537, True, "auto", "fourstep",
     "tpu_ntt.parallel.sharded.ShardedPlan"),
    (256, 0xFFFFFFFF00000001, True, "auto", "bigq", "tpu_ntt.bigq.BigQPlan"),
])
def test_build_plan_on_cpu(n, q, negacyclic, backend, kind, cls):
    """build_plan builds what select_plan names, and the engine, kyber_plan
    and auto_plan hand out that same plan."""
    from tpu_ntt.dispatch import build_plan
    from tpu_ntt.runtime.engine import PolyMultEngine
    from tpu_ntt.schemes import auto_plan
    got_kind, plan = build_plan(n, q, negacyclic, backend=backend)
    assert got_kind == kind == select_plan(n, q, negacyclic, backend=backend)
    assert type(plan) is _cls(cls)
    eng = PolyMultEngine(n, q, negacyclic=negacyclic, backend=backend)
    assert eng.kind == kind and type(eng.plan) is type(plan)
    if negacyclic and backend == "auto":
        assert type(auto_plan(n, q)) is type(plan)


@pytest.mark.parametrize("n,q,kind,inner", [
    (256, 12289, "fused", "tpu_ntt.transform.Plan"),
    (256, 3329, "fused-incomplete", "tpu_ntt.schemes.IncompletePlan"),
])
def test_build_plan_wraps_both_kinds_alike_on_gpu(monkeypatch, n, q, kind,
                                                  inner):
    """On a GPU the fused kernel wraps the full and the incomplete plan
    the same way, for the engine and for kyber_plan/auto_plan alike
    (building does not lower the kernel, so this runs on the CPU)."""
    from tpu_ntt import dispatch
    from tpu_ntt.ops.fused import FusedPolymul
    from tpu_ntt.schemes import auto_plan, kyber_plan
    monkeypatch.setattr(dispatch, "current_platform", lambda: "gpu")
    got_kind, plan = dispatch.build_plan(n, q)
    assert got_kind == kind
    assert isinstance(plan, FusedPolymul) and type(plan.plan) is _cls(inner)
    assert type(auto_plan(n, q).plan) is _cls(inner)
    if q == 3329:
        assert type(kyber_plan().plan) is _cls(inner)
        assert type(kyber_plan(backend="xla")) is _cls(inner)
