"""Command-line interface — the host application (``python -m tpu_ntt``).

Covers the roles of the reference's host binaries:

- ``multiply``  — NTT_HARDWARE_EXE: read two coefficient files
  (coeficientes_a.txt format), run the accelerator flow, write/print C
  (NTT_PCIECommunicationv2.c:109-224 + time_testing256.c file IO).
- ``selftest``  — the progressive loopback bring-up ladder
  (NTT_PCIEComunicationv3/v4 menu diagnostics).
- ``params``    — parameter/test-vector generation: prints the PARAM set
  and optionally emits the full ModelSim vector bundle
  (test_generator/test_generator.py).
- ``bench``     — the timing harness (time_testing256.c), see bench.py.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from .dispatch import BACKENDS


def _cmd_multiply(args):
    from .io import read_coefficients, write_coefficients
    from .runtime.engine import PolyMultEngine

    a = read_coefficients(args.a)
    b = read_coefficients(args.b)
    n = args.n or 1 << (max(len(a), len(b)) - 1).bit_length()
    a = np.pad(a, (0, n - len(a)))[:n]
    b = np.pad(b, (0, n - len(b)))[:n]
    eng = PolyMultEngine(n=n, q=args.q, backend=args.backend,
                         negacyclic=not args.cyclic)
    c = eng.multiply(a[None], b[None])[0]
    if args.out:
        write_coefficients(args.out, c)
        print(f"wrote {args.out} ({eng.kind} backend, n={n}, q={args.q})")
    else:
        print(" ".join(str(int(x)) for x in c))
    return 0


def _cmd_selftest(args):
    from .runtime.engine import PolyMultEngine

    eng = PolyMultEngine(n=args.n, q=args.q, backend=args.backend)
    rep = eng.self_test(verbose=True)
    return 0 if rep.ok else 1


def _cmd_params(args):
    from .params import find_params, make_params

    if args.q:
        p = make_params(args.n, args.q)
    else:
        p = find_params(args.n, args.k)
    print(f"N      : {p.n}")
    print(f"K      : {p.k_bits}")
    print(f"q      : {p.q}")
    print(f"psi    : {p.psi}")
    print(f"psi_inv: {p.psi_inv}")
    print(f"w      : {p.omega}")
    print(f"w_inv  : {p.omega_inv}")
    print(f"n_inv  : {p.n_inv}")
    print(f"log(R) : {p.R.bit_length() - 1}")
    if args.vectors:
        from .io import write_test_vectors
        files = write_test_vectors(p, args.vectors, pe=args.pe)
        print(f"wrote {len(files)} vector files to {args.vectors}")
    return 0


def _cmd_bench(args):
    import bench  # repo-root harness
    sys.argv = ["bench.py"] + args.rest
    bench.main()
    return 0


def main(argv=None) -> int:
    from .utils.jaxcache import enable_compile_cache
    ap = argparse.ArgumentParser(prog="tpu_ntt")
    sub = ap.add_subparsers(dest="cmd", required=True)

    m = sub.add_parser("multiply", help="polynomial product of two "
                       "coefficient files")
    m.add_argument("-a", required=True)
    m.add_argument("-b", required=True)
    m.add_argument("-o", "--out")
    m.add_argument("--n", type=int, default=0, help="ring size "
                   "(default: padded to power of two)")
    m.add_argument("--q", type=int, default=12289)
    m.add_argument("--backend", default="auto", choices=BACKENDS)
    m.add_argument("--cyclic", action="store_true",
                   help="Z_q[x]/(x^n - 1) — the hardware mode-3 "
                        "semantics (PolyMult.v computes the cyclic "
                        "product; default is negacyclic x^n + 1)")
    m.set_defaults(fn=_cmd_multiply)

    s = sub.add_parser("selftest", help="progressive bring-up self-tests")
    s.add_argument("--n", type=int, default=256)
    s.add_argument("--q", type=int, default=12289)
    s.add_argument("--backend", default="auto", choices=BACKENDS)
    s.set_defaults(fn=_cmd_selftest)

    g = sub.add_parser("params", help="parameter search / vector generation")
    g.add_argument("--n", type=int, default=256)
    g.add_argument("--k", type=int, default=14)
    g.add_argument("--q", type=int, default=0)
    g.add_argument("--pe", type=int, default=8)
    g.add_argument("--vectors", help="directory for the test-vector bundle")
    g.set_defaults(fn=_cmd_params)

    b = sub.add_parser("bench", help="timing harness (see bench.py)")
    b.add_argument("rest", nargs="*")
    b.set_defaults(fn=_cmd_bench)

    args = ap.parse_args(argv)
    enable_compile_cache()
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
