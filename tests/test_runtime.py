"""Engine, CLI, IO, profiling and checkpoint tests (the L4/L5 host layer)."""

import json
import subprocess
import sys

import numpy as np
import pytest

from tpu_ntt import io as ntt_io
from tpu_ntt import ref
from tpu_ntt.params import preset
from tpu_ntt.runtime.engine import PolyMultEngine
from tpu_ntt.utils.checkpoint import CheckpointedRun
from tpu_ntt.utils.profiling import polymul_roofline, time_fn


# ---------------------------------------------------------------------------
# engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,q,kind", [
    (256, 12289, "xla"),
    (256, 3329, "incomplete"),
])
def test_engine_dispatch_and_multiply(rng, n, q, kind):
    eng = PolyMultEngine(n=n, q=q)
    assert eng.kind == kind
    a = rng.integers(0, q, (2, n))
    b = rng.integers(0, q, (2, n))
    c = eng.multiply(a, b)
    np.testing.assert_array_equal(
        c[0], ref.schoolbook_negacyclic(a[0], b[0], q))


def test_engine_incomplete_pallas_forced(rng):
    """backend='pallas' demands the fused kernel: on the CPU it raises
    instead of running the interpreter; the kernel over the engine's own
    incomplete plan (interpret mode) is exact."""
    from tpu_ntt.ops.fused import FusedPolymul
    with pytest.raises(RuntimeError, match="GPU"):
        PolyMultEngine(n=256, q=3329, backend="pallas")
    eng = PolyMultEngine(n=256, q=3329, backend="xla")
    fast = FusedPolymul(eng.plan, interpret=True)
    a = rng.integers(0, 3329, (2, 256))
    b = rng.integers(0, 3329, (2, 256))
    c = np.asarray(fast.polymul(a, b))
    np.testing.assert_array_equal(
        c[0], ref.schoolbook_negacyclic(a[0], b[0], 3329))


@pytest.mark.parametrize("n,q", [
    (256, 3331),                  # (q-1) % n != 0: no incomplete transform
    (2048, 12289),                # past the kernel's MAX_N
    (256, (1 << 61) - 1),         # big q: RNS channels, no kernel
])
def test_engine_explicit_pallas_outside_envelope_raises(n, q):
    """An EXPLICIT backend='pallas' outside the fused kernel's envelope
    is a contract violation and raises even on a GPU, mirroring the xla
    posture — not silently degrade to an XLA plan."""
    from tpu_ntt.dispatch import select_plan
    with pytest.raises(ValueError, match="backend='pallas'"):
        select_plan(n, q, backend="pallas", platform="gpu")


def test_engine_dp_sp_mesh(rng):
    """A production-shaped mesh (dp x sp axes) through the engine: the
    transform axis is the innermost mesh axis, the dp axis shards the
    batch."""
    import jax
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    from tpu_ntt.parallel.multihost import global_mesh
    mesh = global_mesh(axes=("dp", "sp"), dp=2)
    eng = PolyMultEngine(n=1024, q=12289, mesh=mesh)
    assert eng.kind == "sharded"
    assert eng.plan.axis == "sp" and eng.plan.batch_axis == "dp"
    a = rng.integers(0, 12289, (2, 1024))
    b = rng.integers(0, 12289, (2, 1024))
    c = eng.multiply(a, b)
    for i in range(2):
        np.testing.assert_array_equal(
            c[i], ref.schoolbook_negacyclic(a[i], b[i], 12289))
    # a batch NOT divisible by dp (1 row on dp=2) is padded internally
    # — the self_test ladder sends 1-row products (r4 review follow-up)
    c1 = eng.multiply(a[:1], b[:1])
    np.testing.assert_array_equal(c1, c[:1])
    rep = eng.self_test()
    assert rep.ok, str(rep)


def test_engine_dp_only_mesh_rejected():
    """A dp-only mesh must fail loudly: a dp axis shards the batch,
    never the transform (r4 review finding)."""
    import jax
    from jax.sharding import Mesh
    devs = np.array(jax.devices()[:2])
    with pytest.raises(ValueError, match="dp"):
        PolyMultEngine(n=1024, q=12289, mesh=Mesh(devs, ("dp",)))


def test_engine_bigq_dispatch(rng):
    from tpu_ntt.params import find_params
    p = find_params(256, 45)
    eng = PolyMultEngine(n=256, q=p.q)
    assert eng.kind == "bigq"
    a = rng.integers(0, p.q, (1, 256)).astype(np.uint64)
    b = rng.integers(0, p.q, (1, 256)).astype(np.uint64)
    c = eng.multiply(a, b)
    want = ref.schoolbook_negacyclic(a[0].astype(object),
                                     b[0].astype(object), p.q)
    np.testing.assert_array_equal(c[0].astype(object), want.astype(object))


def test_engine_self_test():
    rep = PolyMultEngine(n=256, q=12289).self_test()
    assert rep.ok, str(rep)
    names = [s[0] for s in rep.steps]
    assert "device loopback" in names and "known product vector" in names


# ---------------------------------------------------------------------------
# io
# ---------------------------------------------------------------------------

def test_coefficient_file_roundtrip(tmp_path, rng):
    c = rng.integers(0, 12289, 256)
    path = tmp_path / "c.txt"
    ntt_io.write_coefficients(path, c)
    np.testing.assert_array_equal(ntt_io.read_coefficients(path), c)


def test_hex_vector_roundtrip(tmp_path, rng):
    v = rng.integers(0, 1 << 13, 100)
    path = tmp_path / "v.txt"
    ntt_io.write_hex_vectors(path, v)
    np.testing.assert_array_equal(ntt_io.read_hex_vectors(path), v)


def test_vector_bundle_matches_reference_formats(tmp_path, reference_dir):
    """Our generated bundle reproduces the checked-in PARAM/W/WINV files
    verbatim for the hardware parameter point."""
    p = preset("hw256")
    files = ntt_io.write_test_vectors(p, tmp_path)
    base = (reference_dir /
            "Hardware_Multiplier/simulation/modelsim/test")
    for name in ("PARAM", "W", "WINV"):
        ours = ntt_io.read_hex_vectors(files[name])
        theirs = ntt_io.read_hex_vectors(base / f"{name}.txt")
        np.testing.assert_array_equal(ours, theirs, err_msg=name)
    # NTT_DIN/DOUT use a random input (not reproducible bit-for-bit), but
    # must satisfy the same relation: DOUT = hw_ntt(DIN)
    din = ntt_io.read_hex_vectors(files["NTT_DIN"])
    dout = ntt_io.read_hex_vectors(files["NTT_DOUT"])
    np.testing.assert_array_equal(ref.hw_ntt(din, p), dout)


# ---------------------------------------------------------------------------
# cli
# ---------------------------------------------------------------------------

def test_cli_multiply_and_params(tmp_path, rng):
    from tpu_ntt.cli import main
    a = rng.integers(0, 12289, 256)
    b = rng.integers(0, 12289, 256)
    fa, fb, fo = tmp_path / "a.txt", tmp_path / "b.txt", tmp_path / "c.txt"
    ntt_io.write_coefficients(fa, a)
    ntt_io.write_coefficients(fb, b)
    rc = main(["multiply", "-a", str(fa), "-b", str(fb), "-o", str(fo)])
    assert rc == 0
    c = ntt_io.read_coefficients(fo)
    np.testing.assert_array_equal(c, ref.schoolbook_negacyclic(a, b, 12289))

    rc = main(["params", "--n", "256", "--q", "7681",
               "--vectors", str(tmp_path / "vec")])
    assert rc == 0
    assert (tmp_path / "vec" / "PARAM.txt").exists()


def test_cli_selftest(tmp_path):
    from tpu_ntt.cli import main
    assert main(["selftest", "--n", "64", "--q", "12289"]) == 0


# ---------------------------------------------------------------------------
# profiling / checkpoint
# ---------------------------------------------------------------------------

def test_time_fn():
    stats = time_fn(lambda: np.arange(10), warmup=1, iters=5)
    assert stats["iters"] == 5 and stats["mean_s"] >= 0


def test_roofline_report():
    p = preset("sw256")
    r = polymul_roofline(p, batch=8192, measured_s=100e-6,
                         device_kind="NVIDIA H100 80GB HBM3")
    assert r.butterflies == 3 * 8192 * 128 * 8
    assert r.hbm_ceiling == 3.35e12
    assert 0 < r.roofline_fraction < 10
    assert "roofline" in str(r)


def test_roofline_unknown_device_raises():
    """A device without published peaks is an error, never a default."""
    with pytest.raises(KeyError, match="no published peaks"):
        polymul_roofline(preset("sw256"), batch=8, measured_s=1e-3,
                         device_kind="cpu")


def test_checkpointed_run(tmp_path, rng):
    eng = PolyMultEngine(n=64, q=12289)
    a = rng.integers(0, 12289, (10, 64))
    b = rng.integers(0, 12289, (10, 64))
    run = CheckpointedRun(tmp_path / "job", total=10, chunk=4)
    it = iter(run.pending())
    lo, hi = next(it)
    run.complete(lo, hi, eng.multiply(a[lo:hi], b[lo:hi]))
    # simulate crash + resume: new object, only remaining chunks pending
    run2 = CheckpointedRun(tmp_path / "job", total=10, chunk=4)
    pend = list(run2.pending())
    assert (0, 4) not in pend and len(pend) == 2
    for lo, hi in pend:
        run2.complete(lo, hi, eng.multiply(a[lo:hi], b[lo:hi]))
    assert run2.finished
    c = run2.gather()
    np.testing.assert_array_equal(
        c[7], ref.schoolbook_negacyclic(a[7], b[7], 12289))
    # mismatched job shape is refused
    with pytest.raises(ValueError):
        CheckpointedRun(tmp_path / "job", total=12, chunk=4)


def test_watchdog_deadline():
    import time as _t
    from tpu_ntt.utils.watchdog import DeviceTimeout, retry, with_deadline
    assert with_deadline(lambda: 42, 5.0) == 42
    with pytest.raises(DeviceTimeout):
        with_deadline(lambda: _t.sleep(3), 0.2)
    calls = []

    def flaky():
        calls.append(1)
        if len(calls) < 2:
            raise RuntimeError("transient")
        return "ok"

    assert retry(flaky, attempts=3, backoff_s=0.01) == "ok"
    with pytest.raises(RuntimeError):
        retry(lambda: (_ for _ in ()).throw(RuntimeError("always")),
              attempts=2, backoff_s=0.01)


def test_engine_multiply_robust_recovers_from_hang(rng, monkeypatch):
    """Failure-detection wired into the host flow: a multiply that wedges
    (injected hang, the stuck-busy-bit analog) trips the deadline and the
    retry succeeds once the fault clears."""
    import time as _t
    from tpu_ntt.utils.watchdog import DeviceTimeout
    eng = PolyMultEngine(n=256, q=12289)
    a = rng.integers(0, 12289, (2, 256))
    b = rng.integers(0, 12289, (2, 256))
    want = eng.multiply(a, b)

    real = PolyMultEngine.multiply
    calls = []

    def wedged_once(self, x, y):
        calls.append(1)
        if len(calls) == 1:
            _t.sleep(5)                   # wedge: exceeds the deadline
        return real(self, x, y)

    monkeypatch.setattr(PolyMultEngine, "multiply", wedged_once)
    c = eng.multiply_robust(a, b, deadline_s=0.5, attempts=2,
                            backoff_s=0.01)
    np.testing.assert_array_equal(c, want)
    assert len(calls) == 2

    # a permanently wedged device surfaces DeviceTimeout after attempts
    monkeypatch.setattr(PolyMultEngine, "multiply",
                        lambda self, x, y: _t.sleep(5))
    with pytest.raises(DeviceTimeout):
        eng.multiply_robust(a, b, deadline_s=0.2, attempts=2,
                            backoff_s=0.01)


def test_engine_multiply_batch_checkpointed(tmp_path, rng, monkeypatch):
    """multiply_batch resumes from the last complete chunk after a crash
    mid-job (checkpoint/resume + watchdog composed at the engine level)."""
    eng = PolyMultEngine(n=256, q=12289)
    a = rng.integers(0, 12289, (10, 256))
    b = rng.integers(0, 12289, (10, 256))
    want = eng.multiply(a, b)

    real = PolyMultEngine.multiply
    calls = []

    def crash_on_third(self, x, y):
        calls.append(1)
        if len(calls) == 3:
            raise RuntimeError("injected crash")
        return real(self, x, y)

    monkeypatch.setattr(PolyMultEngine, "multiply", crash_on_third)
    with pytest.raises(RuntimeError):
        eng.multiply_batch(tmp_path / "job", a, b, chunk=3, attempts=1)
    # resume: only the missing chunks rerun
    done_before = len(list(CheckpointedRun(tmp_path / "job", total=10,
                                           chunk=3).pending()))
    assert 0 < done_before < 4
    # resuming with DIFFERENT inputs of the same shape must refuse —
    # stale chunks from the old data would silently corrupt the result
    a2 = (a + 1) % 12289
    with pytest.raises(ValueError, match="fingerprint"):
        eng.multiply_batch(tmp_path / "job", a2, b, chunk=3, attempts=1)
    c = eng.multiply_batch(tmp_path / "job", a, b, chunk=3, attempts=1)
    np.testing.assert_array_equal(c, want)


def test_engine_large_n_dispatch():
    """Single device + n>8192: the engine picks the XLA four-step plan on
    a one-device mesh, on the CPU and on a GPU alike."""
    from tpu_ntt.dispatch import select_plan
    eng = PolyMultEngine(n=16384, q=65537)
    assert eng.kind == "fourstep" and eng.plan.mesh.size == 1
    assert select_plan(16384, 65537, platform="gpu") == "fourstep"


# ---------------------------------------------------------------------------
# staged-buffer session (the v1 address-mapped host protocol analog)
# ---------------------------------------------------------------------------

def test_staged_session_matches_engine(rng):
    """StagedSession products are bit-exact with the generic engine path
    for xla and incomplete kinds; results can stay device-resident."""
    from tpu_ntt.runtime.staged import StagedSession
    for q in (12289, 3329):
        eng = PolyMultEngine(n=256, q=q)
        sess = StagedSession(eng, batch=4)
        a = rng.integers(0, q, (4, 256))
        b = rng.integers(0, q, (4, 256))
        np.testing.assert_array_equal(sess.multiply(a, b),
                                      eng.multiply(a, b))
        dev = sess.multiply_device(a, b)     # no d2h
        assert not isinstance(dev, np.ndarray)
        np.testing.assert_array_equal(np.asarray(dev), eng.multiply(a, b))


def test_staged_session_fixed_shape_contract(rng):
    from tpu_ntt.runtime.staged import StagedSession
    eng = PolyMultEngine(n=256, q=12289)
    sess = StagedSession(eng, batch=2)
    a = rng.integers(0, 12289, (3, 256))
    with pytest.raises(ValueError, match="fixed at shape"):
        sess.multiply(a, a)
    # unsupported kinds state the contract
    import jax
    if len(jax.devices()) >= 2:
        from tpu_ntt.parallel.sharded import make_mesh
        eng2 = PolyMultEngine(n=1024, q=12289, mesh=make_mesh(2))
        with pytest.raises(NotImplementedError, match="single-chip"):
            StagedSession(eng2, batch=2)


def test_staged_session_buffer_reuse(rng):
    """A stage()d operand feeds MULTIPLE products (the address-mapped-
    RAM posture) and a previous device result chains as an operand —
    the r5 review found donate_argnums deleted these buffers after the
    first call on real hardware."""
    from tpu_ntt.runtime.staged import StagedSession
    eng = PolyMultEngine(n=256, q=12289)
    sess = StagedSession(eng, batch=2)
    a = rng.integers(0, 12289, (2, 256))
    b1 = rng.integers(0, 12289, (2, 256))
    b2 = rng.integers(0, 12289, (2, 256))
    buf = sess.stage(a)
    c1 = sess.multiply_device(buf, b1)
    c2 = sess.multiply_device(buf, b2)          # buf reused: must work
    c3 = sess.multiply_device(c1, b2)           # device result chains
    np.testing.assert_array_equal(np.asarray(c1), eng.multiply(a, b1))
    np.testing.assert_array_equal(np.asarray(c2), eng.multiply(a, b2))
    np.testing.assert_array_equal(
        np.asarray(c3), eng.multiply(np.asarray(c1), b2))


def test_staged_session_overhead_harness(rng):
    """measure_overhead runs and reports both paths (CPU numbers are not
    meaningful; on a GPU it runs in
    test_gpu_parity.py::test_staged_session_on_device)."""
    from tpu_ntt.runtime.staged import StagedSession
    eng = PolyMultEngine(n=256, q=12289)
    sess = StagedSession(eng, batch=4)
    d = sess.measure_overhead(iters=3)
    assert d["staged_us"] > 0 and d["engine_us"] > 0
    assert d["batch"] == 4 and d["n"] == 256


def test_cli_multiply_cyclic(tmp_path, rng):
    """--cyclic computes the hardware mode-3 semantics through the CLI."""
    from tpu_ntt.cli import main
    a = rng.integers(0, 7681, 256)
    b = rng.integers(0, 7681, 256)
    fa, fb, fo = tmp_path / "a.txt", tmp_path / "b.txt", tmp_path / "c.txt"
    ntt_io.write_coefficients(fa, a)
    ntt_io.write_coefficients(fb, b)
    rc = main(["multiply", "-a", str(fa), "-b", str(fb), "--q", "7681",
               "--cyclic", "-o", str(fo)])
    assert rc == 0
    np.testing.assert_array_equal(ntt_io.read_coefficients(fo),
                                  ref.schoolbook_cyclic(a, b, 7681))
