"""``chip_smoke.py`` on the CPU: ``--rehearse`` on one and on four
devices, and the refusal to run without a GPU or outside a checkout."""

import json
import os
import pathlib
import shutil
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _run(args, cwd=ROOT, devices=None, timeout=900):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    if devices:
        env["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={devices}"
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=timeout)


@pytest.mark.parametrize("four", [False, True], ids=["one", "four"])
def test_chip_smoke_rehearse(four):
    """Every phase runs end to end at tiny sizes; the last line is the
    result object, naming the device JAX reports."""
    r = _run(["chip_smoke.py", "--rehearse"] + (["--four"] if four else []),
             devices=4 if four else None)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    last = json.loads(r.stdout.strip().splitlines()[-1])
    assert last == {"ok": True, "device": {
        "platform": "cpu", "kind": "cpu", "count": 4 if four else 1}}
    assert "[FAIL]" not in r.stdout


def test_chip_smoke_refuses_cpu():
    r = _run(["chip_smoke.py"], timeout=300)
    assert r.returncode != 0
    assert r.stdout == ""
    assert "needs a GPU" in r.stderr


def test_chip_smoke_alone_fails(tmp_path):
    """Without the rest of the repository the script fails and prints no
    result."""
    shutil.copy(ROOT / "chip_smoke.py", tmp_path)
    r = _run(["chip_smoke.py"], cwd=tmp_path, timeout=300)
    assert r.returncode != 0
    assert r.stdout == ""


def test_count_kernels_skips_fusion_bodies():
    """The kernel count of the kernel phase: fusions and custom calls of
    the entry and of called computations, not the ops inside a fusion
    body."""
    sys.path.insert(0, str(ROOT))
    from chip_smoke import count_kernels
    hlo = """HloModule jit_f, entry_computation_layout={(s32[8,4]{1,0})->s32[8,4]{1,0}}

%fused_add (p.0: s32[8,4]) -> s32[8,4] {
  %p.0 = s32[8,4]{1,0} parameter(0)
  %c = s32[8,4]{1,0} fusion(%p.0), kind=kLoop, calls=%inner
  ROOT %add = s32[8,4]{1,0} add(%p.0, %c)
}

%command_buffer (p: s32[8,4]) -> (s32[8,4], s32[8,4]) {
  %p = s32[8,4]{1,0} parameter(0)
  %f.1 = (s32[8,4]{1,0}, s32[8,4]{1,0}) fusion(%p), kind=kLoop, calls=%fused_add
  ROOT %t = (s32[8,4]{1,0}, s32[8,4]{1,0}) tuple(%p, %p)
}

ENTRY %main (x: s32[8,4]) -> s32[8,4] {
  %x = s32[8,4]{1,0} parameter(0)
  %loop_add_fusion = s32[8,4]{1,0} fusion(%x), kind=kLoop, calls=%fused_add
  %k = s32[8,4]{1,0} custom-call(%loop_add_fusion), custom_call_target="t"
  %cb = (s32[8,4]{1,0}, s32[8,4]{1,0}) call(%k), to_apply=%command_buffer
  ROOT %y = s32[8,4]{1,0} get-tuple-element(%cb), index=0
}
"""
    assert count_kernels(hlo) == 3
