"""Mesh-sharded four-step transform tests on the 8-virtual-device CPU mesh —
test pyramid layer (e) of SURVEY.md §4 (the loopback-before-pod analog)."""

import os
import jax
import numpy as np
import pytest

from tpu_ntt import ref
from tpu_ntt.params import make_params, preset
from tpu_ntt.parallel.sharded import ShardedPlan, make_mesh
from tpu_ntt.transform import Plan


@pytest.fixture(scope="module")
def mesh():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    return make_mesh(8)


@pytest.mark.parametrize("name", ["sw256", "hw256", "dilithium256"])
def test_sharded_polymul_vs_schoolbook(mesh, rng, name):
    p = preset(name)
    sp = ShardedPlan(p, mesh)
    a = rng.integers(0, p.q, (2, p.n)).astype(np.int32)
    b = rng.integers(0, p.q, (2, p.n)).astype(np.int32)
    c = sp.unshard(sp.polymul_jit(sp.shard_coeffs(a), sp.shard_coeffs(b)))
    oracle = (ref.schoolbook_negacyclic if p.negacyclic
              else ref.schoolbook_cyclic)
    for i in range(2):
        np.testing.assert_array_equal(c[i], oracle(a[i], b[i], p.q))


@pytest.mark.parametrize("n,q", [(1024, 12289), (4096, 12289),
                                 (4096, 8380417)])
def test_sharded_matches_single_chip(mesh, rng, n, q):
    """Sharded and single-chip pipelines agree bit-exactly — the scaling
    path changes the schedule, never the numbers."""
    p = make_params(n, q)
    sp = ShardedPlan(p, mesh)
    plan = Plan(p)
    a = rng.integers(0, q, (1, n)).astype(np.int32)
    b = rng.integers(0, q, (1, n)).astype(np.int32)
    got = sp.unshard(sp.polymul_jit(sp.shard_coeffs(a), sp.shard_coeffs(b)))
    want = np.asarray(plan.polymul_jit(a, b))
    np.testing.assert_array_equal(got, want)


def test_sharded_roundtrip(mesh, rng):
    p = make_params(1024, 12289)
    sp = ShardedPlan(p, mesh)
    a = rng.integers(0, p.q, (3, p.n)).astype(np.int32)
    f = sp.forward_jit(sp.shard_coeffs(a))
    g = sp.unshard(sp.inverse_jit(f))
    np.testing.assert_array_equal(g, a)


def test_spectrum_is_permutation_of_standard(mesh, rng):
    """The four-step spectrum is the standard spectrum under a fixed
    data-independent permutation (bitrev-per-factor x transpose)."""
    p = make_params(1024, 12289)
    sp = ShardedPlan(p, mesh)
    a = rng.integers(0, p.q, (1, p.n)).astype(np.int32)
    f = sp.unshard(sp.forward_jit(sp.shard_coeffs(a)))[0]
    # standard-order negacyclic spectrum from the oracle
    from tpu_ntt.utils.bitrev import bit_reverse_permute
    from tpu_ntt.params import psi_powers
    tw = a[0] * psi_powers(p) % p.q
    std = bit_reverse_permute(ref.ntt(tw, p, "ct", "std2rev"))
    assert sorted(f.tolist()) == sorted(std.tolist())
    # and the permutation is the documented one: pos (k1p, k2p) holds
    # frequency bitrev(k1p) + n1*bitrev_within(k2p)
    from tpu_ntt.utils.bitrev import bit_reverse_indices
    r1 = bit_reverse_indices(sp.n1)
    r2 = bit_reverse_indices(sp.n2)
    fm = f.reshape(sp.n1, sp.n2)
    for k1p in range(0, sp.n1, 7):
        for k2p in range(0, sp.n2, 5):
            freq = r1[k1p] + sp.n1 * r2[k2p]
            assert fm[k1p, k2p] == std[freq]


def _count_a2a(fn, *args):
    """Number of all_to_all collectives in the lowered computation."""
    import re
    txt = jax.jit(fn).lower(*args).as_text()
    return len(re.findall(r"all[-_]to[-_]all", txt, re.IGNORECASE))


@pytest.mark.parametrize("n,q", [(1024, 12289), (4096, 134348801)])
def test_polymul_chain_bit_exact_and_2_collectives(mesh, rng, n, q):
    """Transposed-domain chained products (SCALING.md §2 headroom item,
    VERDICT r3 next #4): ((a·b1)·b2)·b3 via ONE stacked forward
    collective + spectral products + ONE inverse collective, bit-exact
    with three sequential polymuls (incl. the Montgomery pointwise_fix
    bookkeeping at the 28-bit q), with the collective count measured
    from the lowered graph: 2 vs 6."""
    p = make_params(n, q)
    sp = ShardedPlan(p, mesh)
    k = 3
    a = rng.integers(0, q, (2, n)).astype(np.int32)
    bs = [rng.integers(0, q, (2, n)).astype(np.int32) for _ in range(k)]
    got = sp.polymul_chain(a, bs)
    want = a
    for b in bs:
        want = sp.unshard(sp.polymul_jit(sp.shard_coeffs(want),
                                         sp.shard_coeffs(b)))
    np.testing.assert_array_equal(got, want)
    stacked = sp.shard_chain(a, bs)
    n_chain = _count_a2a(sp.polymul_chain_jit(k), stacked)
    sa = sp.shard_coeffs(a)
    n_single = _count_a2a(sp.polymul_jit, sa, sa)
    assert n_chain == 2, n_chain
    assert n_single == 2, n_single          # so the chain saves 2k-2


def test_polymul_chain_k1_degenerates_to_polymul(mesh, rng):
    """A 1-chain is exactly one product (no fix correction path)."""
    p = make_params(1024, 12289)
    sp = ShardedPlan(p, mesh)
    a = rng.integers(0, p.q, (2, p.n)).astype(np.int32)
    b = rng.integers(0, p.q, (2, p.n)).astype(np.int32)
    got = sp.polymul_chain(a, [b])
    want = sp.unshard(sp.polymul_jit(sp.shard_coeffs(a),
                                     sp.shard_coeffs(b)))
    np.testing.assert_array_equal(got, want)


def test_polymul_chain_dp_sharded(rng):
    """Chain with the batch axis dp-sharded: operands must ride a NEW
    leading stack axis — stacking along batch interleaves different
    operands' rows across dp shards (r4 bug caught by
    dryrun_multichip on the dp=2 x sp=4 mesh)."""
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    from tpu_ntt.parallel.multihost import global_mesh
    m = global_mesh(axes=("dp", "sp"), dp=2)
    p = make_params(1024, 12289)
    sp = ShardedPlan(p, m, axis="sp", batch_axis="dp")
    a = rng.integers(0, p.q, (2, p.n)).astype(np.int32)
    bs = [rng.integers(0, p.q, (2, p.n)).astype(np.int32)
          for _ in range(2)]
    got = sp.polymul_chain(a, bs)
    want = a
    for b in bs:
        want = sp.unshard(sp.polymul_jit(sp.shard_coeffs(want),
                                         sp.shard_coeffs(b)))
    np.testing.assert_array_equal(got, want)


def test_polymul_overlapped_bit_exact(mesh, rng):
    """Double-buffered comm/compute overlap: bit-exact with polymul_jit;
    4 half-volume collectives instead of 2 (each ridable under the other
    half's local transforms)."""
    p = make_params(4096, 134348801)
    sp = ShardedPlan(p, mesh)
    a = rng.integers(0, p.q, (4, p.n)).astype(np.int32)
    b = rng.integers(0, p.q, (4, p.n)).astype(np.int32)
    sa, sb = sp.shard_coeffs(a), sp.shard_coeffs(b)
    got = sp.unshard(sp.polymul_overlapped_jit(sa, sb))
    want = sp.unshard(sp.polymul_jit(sa, sb))
    np.testing.assert_array_equal(got, want)
    assert _count_a2a(sp.polymul_overlapped_jit, sa, sb) == 4
    # odd per-shard batch fails loudly, not with a shape error deep in
    # the shard_map body (r4 review finding)
    a1 = rng.integers(0, p.q, (1, p.n)).astype(np.int32)
    with pytest.raises(ValueError, match="PER-SHARD batch"):
        sp.polymul_overlapped_jit(sp.shard_coeffs(a1),
                                  sp.shard_coeffs(a1))


def test_mesh_divisibility_error(mesh):
    p = make_params(256, 12289)
    with pytest.raises(ValueError):
        ShardedPlan(p, mesh, n1=128)   # n2=2 not divisible by 8


def test_single_device_mesh(rng):
    """D=1 degenerates to a local four-step — same numbers."""
    p = preset("sw256")
    sp = ShardedPlan(p, make_mesh(1))
    a = rng.integers(0, p.q, (1, p.n)).astype(np.int32)
    b = rng.integers(0, p.q, (1, p.n)).astype(np.int32)
    c = sp.unshard(sp.polymul_jit(sp.shard_coeffs(a), sp.shard_coeffs(b)))
    np.testing.assert_array_equal(
        c[0], ref.schoolbook_negacyclic(a[0], b[0], p.q))


def test_scaling_sweep(mesh):
    """Weak-scaling harness runs and reports efficiency (CPU mesh numbers
    are not meaningful, only the plumbing is under test)."""
    from tpu_ntt.parallel.multihost import scaling_sweep
    from tpu_ntt.params import make_params

    res = scaling_sweep(lambda d: make_params(1024 * d, 12289 if d <= 2
                                              else 786433),
                        [1, 2], iters=2)
    assert len(res) == 2
    assert res[0]["efficiency"] == 1.0
    assert res[1]["devices"] == 2 and res[1]["n"] == 2048


def test_scaling_sweep_marks_truncation(mesh):
    """Device counts past reality are MARKED skipped rows, not silently
    dropped — a truncated sweep must be distinguishable from a complete
    one (VERDICT r4 weak #4)."""
    from tpu_ntt.parallel.multihost import scaling_sweep
    from tpu_ntt.params import make_params

    res = scaling_sweep(lambda d: make_params(1024 * d, 786433),
                        [1, 64], iters=1)
    assert len(res) == 2
    assert res[0]["efficiency"] == 1.0 and not res[0].get("skipped")
    assert res[1] == {"devices": 64, "skipped": True,
                      "reason": "only 8 devices present"}


def test_initialize_raises_on_configured_failure(monkeypatch):
    """A distributed-looking environment whose initialize fails must
    raise, not silently degrade to single-host; a genuinely unconfigured
    single host stays a quiet no-op (VERDICT r4 weak #4)."""
    import jax
    from tpu_ntt.parallel import multihost

    def boom(*a, **k):
        raise RuntimeError("cannot connect to coordinator")

    monkeypatch.setattr(jax.distributed, "initialize", boom)

    # unconfigured: quiet no-op
    for k in multihost._DIST_ENV:
        monkeypatch.delenv(k, raising=False)
    multihost.initialize()

    # env-configured: the failure surfaces
    monkeypatch.setenv("COORDINATOR_ADDRESS", "badhost:1234")
    with pytest.raises(RuntimeError, match="refusing to degrade"):
        multihost.initialize()

    # explicit-args path: jax's own error propagates untouched
    monkeypatch.delenv("COORDINATOR_ADDRESS")
    with pytest.raises(RuntimeError, match="cannot connect"):
        multihost.initialize(coordinator="badhost:1234",
                             num_processes=2, process_id=0)


def test_initialize_idempotent(monkeypatch):
    """A repeat initialize() on an already-initialized distributed
    runtime is SUCCESS — the initialize_and_mesh()-after-initialize()
    pattern must not trip the refuse-to-degrade guard (r5 review)."""
    import jax
    from tpu_ntt.parallel import multihost

    def already(*a, **k):
        raise RuntimeError("Distributed system is already initialized")

    monkeypatch.setattr(jax.distributed, "initialize", already)
    monkeypatch.setenv("COORDINATOR_ADDRESS", "host:1")
    multihost.initialize()                       # env-configured repeat
    multihost.initialize(coordinator="host:1", num_processes=2,
                         process_id=0)           # explicit-args repeat


def test_global_mesh_shape():
    from tpu_ntt.parallel.multihost import global_mesh
    m = global_mesh(dp=2)
    assert m.shape["dp"] == 2
    import pytest as _pytest
    with _pytest.raises(ValueError):
        global_mesh(dp=3)


def test_dp_polymul_plan_and_pallas(rng):
    """Data-parallel wrapper over the 8-device mesh: per-device local
    products, results identical to single-device for both the XLA plan
    and the fused kernel (interpret mode on CPU)."""
    from tpu_ntt.ops.fused import FusedPolymul
    from tpu_ntt.parallel.sharded import dp_polymul, make_mesh
    from tpu_ntt.params import preset
    from tpu_ntt.transform import Plan

    p = preset("sw256")
    mesh = make_mesh(8, axis="dp")
    a = rng.integers(0, p.q, (16, p.n)).astype(np.int32)
    b = rng.integers(0, p.q, (16, p.n)).astype(np.int32)
    want = np.asarray(Plan(p).polymul_jit(a, b))

    for plan in (Plan(p), FusedPolymul(Plan(p), interpret=True)):
        f = dp_polymul(plan, mesh)
        np.testing.assert_array_equal(np.asarray(f(a, b)), want)


def test_multihost_initialize_and_global_mesh():
    """Exercise the jax.distributed DCN init path end-to-end (1-process
    coordinator on localhost) and run a sharded product on the resulting
    global mesh — the single-machine twin of a pod bring-up
    (NTT_PCIECommunicationv2.c's open-then-selftest discipline)."""
    import socket
    import subprocess
    import sys

    # ephemeral free port: a hardcoded one collides with concurrent test
    # sessions (ADVICE r2)
    with socket.socket() as s:
        s.bind(("", 0))
        port = s.getsockname()[1]

    code = r"""
import jax
jax.config.update("jax_platforms", "cpu")
import numpy as np
from tpu_ntt.parallel import multihost
from tpu_ntt.parallel.sharded import ShardedPlan
from tpu_ntt.params import find_params
from tpu_ntt import ref

multihost.initialize(coordinator="localhost:%d", num_processes=1,
                     process_id=0)""" % port + r"""
assert jax.process_count() == 1
mesh = multihost.global_mesh(axes=("dp", "sp"), dp=1)
assert mesh.shape == {"dp": 1, "sp": 4}
p = find_params(1 << 12, 28)
sp = ShardedPlan(p, mesh, axis="sp")
rng = np.random.default_rng(0)
a = rng.integers(0, p.q, (1, p.n))
b = rng.integers(0, p.q, (1, p.n))
c = sp.unshard(sp.polymul_jit(sp.shard_coeffs(a), sp.shard_coeffs(b)))
want = ref.schoolbook_negacyclic(a[0].astype(object), b[0].astype(object),
                                 p.q)
assert np.array_equal(c[0].astype(object), want.astype(object)), "MISMATCH"
print("MULTIHOST-OK")
"""
    env = dict(os.environ,
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               JAX_PLATFORMS="cpu", JAX_PLATFORM_NAME="cpu")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300, env=env)
    assert "MULTIHOST-OK" in r.stdout, r.stdout + r.stderr


def test_multiprocess_dcn_sharded_polymul():
    """REAL multi-process DCN: two jax.distributed processes (Gloo over
    localhost, 2 virtual CPU devices each) run a ShardedPlan polymul
    whose sequence-parallel axis SPANS the process boundary, so the
    four-step all_to_all crosses processes.  Each process verifies its
    addressable shards bit-exactly against the schoolbook oracle — the
    cross-process twin of the reference's host<->device transport layer
    (NTT_PCIECommunicationv2.c:109-224)."""
    import json
    import socket
    import subprocess
    import sys

    with socket.socket() as s:
        s.bind(("", 0))
        port = s.getsockname()[1]

    worker = r"""
import sys
proc_id = int(sys.argv[1]); port = int(sys.argv[2])
import jax
jax.config.update("jax_platforms", "cpu")
import numpy as np
from tpu_ntt.parallel import multihost
from tpu_ntt.parallel.sharded import ShardedPlan
from tpu_ntt.params import find_params
from tpu_ntt import ref

multihost.initialize(coordinator=f"localhost:{port}", num_processes=2,
                     process_id=proc_id)
assert jax.process_count() == 2
assert len(jax.devices()) == 4 and len(jax.local_devices()) == 2
mesh = multihost.global_mesh(axes=("dp", "sp"), dp=1)
p = find_params(1 << 12, 28)
sp = ShardedPlan(p, mesh, axis="sp")
rng = np.random.default_rng(0)           # same data on every process
a = rng.integers(0, p.q, (1, p.n))
b = rng.integers(0, p.q, (1, p.n))
c = sp.polymul_jit(sp.shard_coeffs(a), sp.shard_coeffs(b))
# verify THIS process's addressable shards against the oracle
want = np.asarray(ref.schoolbook_negacyclic(
    a[0].astype(object), b[0].astype(object), p.q)).astype(np.int64)
want3 = want.reshape(1, sp.n1, sp.n2)
nsh = 0
for shard in c.addressable_shards:
    np.testing.assert_array_equal(
        np.asarray(shard.data).astype(np.int64), want3[shard.index])
    nsh += 1
assert nsh == 2, nsh
print(f"proc {proc_id}: DCN-OK shards={nsh} n={p.n} q={p.q} "
      f"mesh={dict(mesh.shape)}", flush=True)
"""
    env = dict(os.environ,
               XLA_FLAGS="--xla_force_host_platform_device_count=2",
               JAX_PLATFORMS="cpu", JAX_PLATFORM_NAME="cpu")
    procs = [subprocess.Popen(
        [sys.executable, "-c", worker, str(i), str(port)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env) for i in range(2)]
    outs = []
    for i, pr in enumerate(procs):
        out, _ = pr.communicate(timeout=240)
        outs.append(out)
        assert pr.returncode == 0, f"proc {i} failed:\n{out}"
        assert f"proc {i}: DCN-OK" in out, out


def test_multiprocess_dcn_dp_and_sp_4proc():
    """The PRODUCTION topology across real process boundaries: 4
    jax.distributed processes (1 virtual CPU device each), mesh
    dp=2 × sp=2 — the data-parallel axis AND the sequence-parallel
    all_to_all both span process boundaries (VERDICT r3 next #5; round
    3's only DCN evidence kept dp inside one process).  Every process
    verifies its addressable shards bit-exactly vs schoolbook."""
    import socket
    import subprocess
    import sys

    with socket.socket() as s:
        s.bind(("", 0))
        port = s.getsockname()[1]

    worker = r"""
import sys
proc_id = int(sys.argv[1]); port = int(sys.argv[2])
import jax
jax.config.update("jax_platforms", "cpu")
import numpy as np
from tpu_ntt.parallel import multihost
from tpu_ntt.parallel.sharded import ShardedPlan
from tpu_ntt.params import find_params
from tpu_ntt import ref

multihost.initialize(coordinator=f"localhost:{port}", num_processes=4,
                     process_id=proc_id)
assert jax.process_count() == 4
assert len(jax.devices()) == 4 and len(jax.local_devices()) == 1
mesh = multihost.global_mesh(axes=("dp", "sp"), dp=2)
assert dict(mesh.shape) == {"dp": 2, "sp": 2}
p = find_params(1 << 12, 28)
sp = ShardedPlan(p, mesh, axis="sp", batch_axis="dp")
rng = np.random.default_rng(0)               # same data on every process
a = rng.integers(0, p.q, (2, p.n))           # one batch row per dp group
b = rng.integers(0, p.q, (2, p.n))
c = sp.polymul_jit(sp.shard_coeffs(a), sp.shard_coeffs(b))
want = np.stack([np.asarray(ref.schoolbook_negacyclic(
    a[i].astype(object), b[i].astype(object), p.q)).astype(np.int64)
    for i in range(2)]).reshape(2, sp.n1, sp.n2)
nsh = 0
for shard in c.addressable_shards:
    np.testing.assert_array_equal(
        np.asarray(shard.data).astype(np.int64), want[shard.index])
    nsh += 1
assert nsh == 1, nsh
print(f"proc {proc_id}: DCN4-OK mesh={dict(mesh.shape)}", flush=True)
"""
    env = dict(os.environ,
               XLA_FLAGS="--xla_force_host_platform_device_count=1",
               JAX_PLATFORMS="cpu", JAX_PLATFORM_NAME="cpu")
    procs = [subprocess.Popen(
        [sys.executable, "-c", worker, str(i), str(port)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env) for i in range(4)]
    for i, pr in enumerate(procs):
        out, _ = pr.communicate(timeout=240)
        assert pr.returncode == 0, f"proc {i} failed:\n{out}"
        assert f"proc {i}: DCN4-OK" in out, out


def test_multiprocess_worker_death_surfaces_timeout():
    """Failure path at process scale (VERDICT r3 next #5): a healthy
    2-process product, then one worker dies; the survivor's
    ``polymul_robust`` must surface DeviceTimeout within its deadline
    instead of hanging the job — the reference's bounded busy/done
    polling + reboot-after-wedge posture
    (NTT_PCIECommunicationv2.c:56-103) across DCN."""
    import socket
    import subprocess
    import sys
    import time

    with socket.socket() as s:
        s.bind(("", 0))
        port = s.getsockname()[1]

    worker = r"""
import os, sys, time
proc_id = int(sys.argv[1]); port = int(sys.argv[2])
import jax
jax.config.update("jax_platforms", "cpu")
import numpy as np
from tpu_ntt.parallel import multihost
from tpu_ntt.parallel.sharded import ShardedPlan
from tpu_ntt.params import find_params
from tpu_ntt.utils.watchdog import DeviceTimeout

multihost.initialize(coordinator=f"localhost:{port}", num_processes=2,
                     process_id=proc_id)
mesh = multihost.global_mesh(axes=("dp", "x"), dp=1)
p = find_params(1 << 12, 28)
sp = ShardedPlan(p, mesh)
rng = np.random.default_rng(0)
a = sp.shard_coeffs(rng.integers(0, p.q, (1, p.n)))
b = sp.shard_coeffs(rng.integers(0, p.q, (1, p.n)))
# healthy product (compiles + runs the cross-process collective)
sp.polymul_robust(a, b, deadline_s=120, attempts=1)
print(f"proc {proc_id}: HEALTHY-OK", flush=True)
if proc_id == 1:
    time.sleep(1)
    os._exit(1)                              # die mid-session
time.sleep(3)                                # let the peer die first
t0 = time.time()
try:
    sp.polymul_robust(a, b, deadline_s=15, attempts=1)
    print("proc 0: UNEXPECTED-SUCCESS", flush=True)
except DeviceTimeout:
    print(f"proc 0: TIMEOUT-SURFACED wall={time.time()-t0:.1f}s",
          flush=True)
except Exception as e:                       # fast collective error is
    print(f"proc 0: PEER-ERROR-SURFACED {type(e).__name__} "    # also a
          f"wall={time.time()-t0:.1f}s", flush=True)     # detected fail
"""
    env = dict(os.environ,
               XLA_FLAGS="--xla_force_host_platform_device_count=1",
               JAX_PLATFORMS="cpu", JAX_PLATFORM_NAME="cpu")
    procs = [subprocess.Popen(
        [sys.executable, "-c", worker, str(i), str(port)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env) for i in range(2)]
    out1, _ = procs[1].communicate(timeout=240)
    assert "proc 1: HEALTHY-OK" in out1, out1
    out0, _ = procs[0].communicate(timeout=240)
    assert "proc 0: HEALTHY-OK" in out0, out0
    surfaced = ("TIMEOUT-SURFACED" in out0
                or "PEER-ERROR-SURFACED" in out0)
    assert surfaced and "UNEXPECTED-SUCCESS" not in out0, out0


# ---------------------------------------------------------------------------
# hierarchical 2-D sp exchange (VERDICT r4 next #3)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def mesh2d():
    from tpu_ntt.parallel.sharded import make_mesh_hier
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    return make_mesh_hier(2, 4)


def test_hier_polymul_vs_schoolbook_and_1d(mesh2d, rng):
    """2-D (sp1=2, sp2=4) hierarchical exchange: bit-exact vs the
    schoolbook AND vs the 1-D joint-axis plan (the schedule changes,
    never the numbers)."""
    p = make_params(1024, 12289)
    sp = ShardedPlan(p, mesh2d, axis=("sp1", "sp2"))
    assert sp.d == 8
    a = rng.integers(0, p.q, (2, p.n)).astype(np.int32)
    b = rng.integers(0, p.q, (2, p.n)).astype(np.int32)
    c = sp.unshard(sp.polymul_jit(sp.shard_coeffs(a), sp.shard_coeffs(b)))
    for i in range(2):
        np.testing.assert_array_equal(
            c[i], ref.schoolbook_negacyclic(a[i], b[i], p.q))
    sp1d = ShardedPlan(p, make_mesh(8))
    w = sp1d.unshard(sp1d.polymul_jit(sp1d.shard_coeffs(a),
                                      sp1d.shard_coeffs(b)))
    np.testing.assert_array_equal(c, w)


def test_hier_roundtrip_and_spectrum_layout(mesh2d, rng):
    """forward/inverse invert through the reversed-axes spectrum layout;
    the spectrum spec is P(batch, (sp2, sp1), None) by construction."""
    from jax.sharding import PartitionSpec as P
    p = make_params(4096, 12289)
    sp = ShardedPlan(p, mesh2d, axis=("sp1", "sp2"))
    assert sp.spec_spec == P(None, ("sp2", "sp1"), None)
    a = rng.integers(0, p.q, (3, p.n)).astype(np.int32)
    f = sp.forward_jit(sp.shard_coeffs(a))
    g = sp.unshard(sp.inverse_jit(f))
    np.testing.assert_array_equal(g, a)
    # spectral pointwise path: intt(f(a) * f(b)) == polymul(a, b)
    b = rng.integers(0, p.q, (3, p.n)).astype(np.int32)
    want = sp.unshard(sp.polymul_jit(sp.shard_coeffs(a),
                                     sp.shard_coeffs(b)))
    fb = sp.forward_jit(sp.shard_coeffs(b))
    prod = jax.jit(jax.shard_map(
        sp.arith.mul, mesh=sp.mesh,
        in_specs=(sp.spec_spec, sp.spec_spec), out_specs=sp.spec_spec,
        check_vma=False))(f, fb)
    got = sp.unshard(sp.inverse_jit(prod))
    np.testing.assert_array_equal(got, want)


def test_hier_collective_count(mesh2d, rng):
    """The lowered graph carries exactly 2 all_to_alls per transform
    (one per mesh axis) — 4 per polymul vs the 1-D plan's 2: smaller
    collectives bought with more of them."""
    p = make_params(1024, 12289)
    sp = ShardedPlan(p, mesh2d, axis=("sp1", "sp2"))
    a = sp.shard_coeffs(rng.integers(0, p.q, (2, p.n)))
    b = sp.shard_coeffs(rng.integers(0, p.q, (2, p.n)))
    assert _count_a2a(sp.polymul_jit, a, b) == 4
    sp1d = ShardedPlan(p, make_mesh(8))
    a1 = sp1d.shard_coeffs(rng.integers(0, p.q, (2, p.n)))
    b1 = sp1d.shard_coeffs(rng.integers(0, p.q, (2, p.n)))
    assert _count_a2a(sp1d.polymul_jit, a1, b1) == 2


def test_hier_chain_and_overlap(mesh2d, rng):
    """Chained products and the double-buffered overlap path work
    unchanged on the 2-D mesh (the composition layers are orthogonal to
    the exchange decomposition)."""
    p = make_params(1024, 12289)
    sp = ShardedPlan(p, mesh2d, axis=("sp1", "sp2"))
    a = rng.integers(0, p.q, (2, p.n)).astype(np.int32)
    bs = [rng.integers(0, p.q, (2, p.n)).astype(np.int32)
          for _ in range(3)]
    got = sp.polymul_chain(a, bs)
    want = a
    for b in bs:
        want = np.stack([ref.schoolbook_negacyclic(want[i], b[i], p.q)
                         for i in range(2)])
    np.testing.assert_array_equal(got, want)
    ov = sp.unshard(sp.polymul_overlapped_jit(sp.shard_coeffs(a),
                                              sp.shard_coeffs(bs[0])))
    np.testing.assert_array_equal(
        ov, np.stack([ref.schoolbook_negacyclic(a[i], bs[0][i], p.q)
                      for i in range(2)]))


def test_hier_engine_dispatch(mesh2d, rng):
    """PolyMultEngine on an sp1 x sp2 mesh picks the hierarchical axes."""
    from tpu_ntt.runtime.engine import PolyMultEngine
    eng = PolyMultEngine(n=1024, q=12289, mesh=mesh2d)
    assert eng.kind == "sharded" and eng.plan.axes == ("sp1", "sp2")
    a = rng.integers(0, 12289, (2, 1024))
    b = rng.integers(0, 12289, (2, 1024))
    c = eng.multiply(a, b)
    for i in range(2):
        np.testing.assert_array_equal(
            c[i], ref.schoolbook_negacyclic(a[i], b[i], 12289))


def test_hier_global_mesh_with_dp(rng):
    """Production-shaped hierarchical mesh (dp x sp1 x sp2) through the
    engine: batch dp-sharded, transform on the per-axis exchange."""
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    from tpu_ntt.parallel.multihost import global_mesh
    from tpu_ntt.runtime.engine import PolyMultEngine
    m = global_mesh(axes=("dp", "sp1", "sp2"), dp=2, sp1=2)
    assert dict(m.shape) == {"dp": 2, "sp1": 2, "sp2": 2}
    eng = PolyMultEngine(n=1024, q=12289, mesh=m)
    assert eng.plan.axes == ("sp1", "sp2") and eng.plan.batch_axis == "dp"
    a = rng.integers(0, 12289, (4, 1024))
    b = rng.integers(0, 12289, (4, 1024))
    c = eng.multiply(a, b)
    for i in range(4):
        np.testing.assert_array_equal(
            c[i], ref.schoolbook_negacyclic(a[i], b[i], 12289))
    with pytest.raises(ValueError, match="sp1"):
        global_mesh(axes=("dp", "sp1", "sp2"), dp=2, sp1=3)
