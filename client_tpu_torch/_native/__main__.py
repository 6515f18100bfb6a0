"""``python -m client_tpu_torch._native install --prefix DIR [TARGET...]``
installs the native tree (see :func:`client_tpu_torch._native.install`)."""

import argparse
import sys

from client_tpu_torch import _native


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m client_tpu_torch._native")
    sub = ap.add_subparsers(dest="cmd", required=True)
    inst = sub.add_parser("install", help="lay out include/, lib/, bin/ "
                          "and the CMake package under --prefix")
    inst.add_argument("--prefix", required=True)
    inst.add_argument("targets", nargs="*",
                      help=f"default: {' '.join(_native.INSTALL_TARGETS)} "
                      "where bundled or buildable")
    args = ap.parse_args(argv)
    try:
        done = _native.install(args.prefix, args.targets or None)
    except (RuntimeError, KeyError) as e:
        print(f"client-tpu-torch: {e}", file=sys.stderr)
        return 1
    for name, path in done.items():
        print(f"{name}: {path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
