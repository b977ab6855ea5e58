"""``test_0`` — smoke test of the config plumbing (test_0.cpp)."""

from __future__ import annotations

import sys

from ..utils.params import AliParams, ApplicationParams, Argv, RCfile


def main(argv=None) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    try:
        rc = RCfile()
        z = Argv(argv)
        a = AliParams()
        a.read(rc)
        a.read(z)
        print(f"{a.gap_init_penalty:g}")
        print(f"{a.gap_extn_penalty:g}")
        print(f"C0 {z.count()}")
        r = z.get_switch_arg("-a", 1)
        print(r[0] if r else "")
        print(f"C1 {z.count()}")
        b = ApplicationParams()
        b.read(rc)
        b.read(z)
        print(f"LEN={b.line_length}")
        return 0
    except ValueError as e:
        print(e, file=sys.stderr)
        return -1


if __name__ == "__main__":
    sys.exit(main())
