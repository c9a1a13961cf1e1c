"""Bit-exact parity against the *compiled reference C multipliers* — test
pyramid layer (d) of SURVEY.md §4: the strongest correctness anchor.

The reference sources under /root/reference are compiled (in a temp dir,
nothing is copied into this repo) into a shared library and driven through
ctypes.  Skipped cleanly when the reference mount or a C compiler is absent.
"""

import ctypes
import pathlib
import shutil
import subprocess
import tempfile

import numpy as np
import pytest

from tpu_ntt import ref
from tpu_ntt.params import preset
from tpu_ntt.transform import Plan

SW_DIR = ("NTT_Software/NTT_Software_Evaluations/NTT-256")


def build_c_oracle(reference_dir):
    """Compile the reference NTT-RED and NTT libraries to one .so.

    Shared with tests/test_gpu_parity.py (the on-device parity run uses the
    same compiled oracle).  Calls pytest.skip when compilation is impossible.
    """
    cc = shutil.which("cc") or shutil.which("gcc")
    if cc is None:
        pytest.skip("no C compiler")
    src = reference_dir / SW_DIR
    tmp = tempfile.mkdtemp(prefix="ntt_c_oracle_")
    out = pathlib.Path(tmp) / "libnttoracle.so"
    # .C suffixes would otherwise be treated as C++ (mangled symbols)
    cmd = [cc, "-O2", "-shared", "-fPIC", "-o", str(out), "-x", "c",
           str(src / "NTT-RED/ntt_red.c"),
           str(src / "NTT-RED/ntt_red256.C"),
           str(src / "NTT-RED/ntt_red256_tables.c"),
           str(src / "NTT/ntt.C"),
           str(src / "NTT/ntt256.C"),
           str(src / "NTT/ntt256_tables.C"),
           "-I", str(src / "NTT-RED"), "-I", str(src / "NTT")]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        pytest.skip(f"reference C does not compile here: {res.stderr[:400]}")
    return ctypes.CDLL(str(out))


@pytest.fixture(scope="module")
def c_oracle(reference_dir):
    return build_c_oracle(reference_dir)


def _call_product(lib, name, a, b):
    fn = getattr(lib, name)
    fn.restype = None
    i32p = ctypes.POINTER(ctypes.c_int32)
    c = np.zeros(256, dtype=np.int32)
    # the C products mutate a and b in place (ntt_red256.C:6-14) — pass copies
    ac = np.array(a, dtype=np.int32, copy=True)
    bc = np.array(b, dtype=np.int32, copy=True)
    fn(c.ctypes.data_as(i32p), ac.ctypes.data_as(i32p),
       bc.ctypes.data_as(i32p))
    return c


@pytest.mark.parametrize("cname,kind", [
    ("ntt_red256_product1", "ct"),
    ("ntt_red256_product4", "gs"),
])
def test_red_products_bit_exact(c_oracle, rng, cname, kind):
    p = preset("sw256")
    for _ in range(5):
        a = rng.integers(0, p.q, 256).astype(np.int32)
        b = rng.integers(0, p.q, 256).astype(np.int32)
        want = _call_product(c_oracle, cname, a, b)
        got_np = ref.product_red(a.copy(), b.copy(), p, kind)
        np.testing.assert_array_equal(got_np, want)
        got_jax = np.asarray(Plan(p).polymul_jit(a[None], b[None]))[0]
        np.testing.assert_array_equal(got_jax, want)


@pytest.mark.parametrize("cname,kind", [
    ("ntt256_product1", "ct"),
    ("ntt256_product4", "gs"),
])
def test_plain_products_bit_exact(c_oracle, rng, cname, kind):
    p = preset("sw256")
    for _ in range(5):
        a = rng.integers(0, p.q, 256).astype(np.int32)
        b = rng.integers(0, p.q, 256).astype(np.int32)
        want = _call_product(c_oracle, cname, a, b)
        got_np = ref.product_plain(a.copy(), b.copy(), p, kind)
        np.testing.assert_array_equal(got_np, want)


def test_red_ntt_variant_bit_exact(c_oracle, rng):
    """The raw lazy-reduction transform (unreduced int32 values!) matches
    the C exactly — not just mod q but the exact int32 representatives."""
    p = preset("sw256")
    fn = c_oracle.ntt_red_ct_std2rev
    fn.restype = None
    # ct_std2rev consumes the bit-reversed-order table (ntt_red256.h:29-31)
    tab = (ctypes.c_int16 * 256).in_dll(c_oracle,
                                        "ntt_red256_omega_powers_rev")
    i32p = ctypes.POINTER(ctypes.c_int32)
    i16p = ctypes.POINTER(ctypes.c_int16)
    for _ in range(3):
        a = rng.integers(-21499, 21500, 256).astype(np.int32)
        c_a = a.copy()
        fn(c_a.ctypes.data_as(i32p), ctypes.c_uint32(256),
           ctypes.cast(tab, i16p))
        got = ref.ntt_red(a, p, "ct", "std2rev")
        np.testing.assert_array_equal(got, c_a)


def test_c_smoke_main_reproduced(c_oracle):
    """The checked-in smoke main's exact case (test_prod_nttred256.c:47-61)."""
    a = np.zeros(256, dtype=np.int32)
    b = np.zeros(256, dtype=np.int32)
    a[0], a[1], b[0] = 1, 2, 3
    c = _call_product(c_oracle, "ntt_red256_product1", a, b)
    assert c[0] == 3 and c[1] == 6 and not c[2:].any()
