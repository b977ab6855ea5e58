"""Layered parameter system.

Reimplements the reference config stack (pstore.{h,cpp}, rcfile.{h,cpp},
argv.{h,cpp}, alib.{h,cpp}, noalib.{h,cpp}, application.{h,cpp},
hmap_eval.{h,cpp} param classes) with the same key names and the same
4-layer precedence: compiled defaults <- ~/.hmaprc <- -top file <- --KEY value
command-line overrides.
"""

from __future__ import annotations

import enum
import os
import sys
from dataclasses import dataclass, field


class ParamStore:
    """String key/value store with ``KEY: value`` line syntax (pstore.cpp:64-77)."""

    def __init__(self) -> None:
        self._store: dict[str, str] = {}

    def clear(self) -> None:
        self._store.clear()

    def find(self, key: str) -> bool:
        return key in self._store

    def get_raw(self, key: str) -> str:
        return self._store[key]

    def set_value(self, key: str, value: str) -> bool:
        self._store[key] = str(value)
        return True

    # typed extraction helpers (stand-ins for ``getValue(s) >> v``)
    def get_int(self, key: str, default: int = 0) -> int:
        try:
            return int(self._store[key].split()[0])
        except (KeyError, ValueError, IndexError):
            return default

    def get_float(self, key: str, default: float = 0.0) -> float:
        try:
            return float(self._store[key].split()[0])
        except (KeyError, ValueError, IndexError):
            return default

    def get_str(self, key: str, default: str = "") -> str:
        try:
            return self._store[key].split()[0]
        except (KeyError, IndexError):
            return default

    def get_bool(self, key: str, default: bool = False) -> bool:
        # C++ ``stringstream >> bool`` accepts 0/1
        try:
            return bool(int(self._store[key].split()[0]))
        except (KeyError, ValueError, IndexError):
            return default

    @staticmethod
    def parse_line(line: str) -> tuple[str, str]:
        """Parse ``KEY: value`` (pstore.cpp:parseline)."""
        i0 = line.find(":")
        if i0 < 0:
            raise ValueError("Param parse error")
        key = line[:i0]
        rest = line[i0 + 1 :]
        value = rest.lstrip(" \t")
        return key, value

    def read_stream(self, lines) -> None:
        for line in lines:
            line = line.rstrip("\n")
            if line == "" or line.startswith("#"):
                continue
            key, value = self.parse_line(line)
            self._store[key] = value


class RCfile(ParamStore):
    """ParamStore loaded from ``~/.hmaprc`` or an explicit file (rcfile.cpp)."""

    DEFAULT_RC_FNAME = "~/.hmaprc"

    def __init__(self, fname: str | None = None) -> None:
        super().__init__()
        implicit = fname is None
        fname = fname if fname is not None else self.DEFAULT_RC_FNAME
        fname = os.path.expanduser(fname)
        self.fname = fname
        if not os.path.exists(fname):
            if implicit:
                print(
                    f"No defaults file ({self.DEFAULT_RC_FNAME}).  "
                    "Using programmed defaults.",
                    file=sys.stderr,
                )
                return
            raise FileNotFoundError(f"{fname} file not found")
        with open(fname) as f:
            self.read_stream(f)


class Argv(ParamStore):
    """Command-line parser (argv.cpp): ``--KEY value`` pairs become params,
    ``-switch`` flags queried via :meth:`get_switch`, bare args positional."""

    def __init__(self, argv: list[str]) -> None:
        super().__init__()
        self.dohelp = False
        self.args: list[str] = []
        for a in argv:
            if a == "-help":
                self.dohelp = True
        i = 0
        while i < len(argv):
            a = argv[i]
            if a.startswith("--"):
                if i + 1 >= len(argv):
                    raise ValueError(f"Argument missing for {a}")
                self.set_value(a[2:], argv[i + 1])
                i += 2
            else:
                self.args.append(a)
                i += 1

    def count(self) -> int:
        return len(self.args)

    def get_arg(self, c: int) -> str:
        if c >= len(self.args):
            raise ValueError("Command line arg missing")
        return self.args[c]

    def get_switch(self, sw: str, erase: bool = True) -> bool:
        if sw in self.args:
            if erase:
                self.args.remove(sw)
            return True
        return False

    def get_switch_arg(self, sw: str, nvals: int = 1, erase: bool = True):
        """``-sw v1 .. vn``; returns list of values (argv.cpp getSwitch/c)."""
        if sw not in self.args:
            raise ValueError(f"Switch arg missing for {sw}")
        i = self.args.index(sw)
        vals = self.args[i + 1 : i + 1 + nvals]
        if len(vals) < nvals:
            raise ValueError(f"Switch arg missing for {sw}")
        if erase:
            del self.args[i : i + 1 + nvals]
        return vals if nvals > 1 else vals[0]


class AlignT(enum.IntEnum):
    """Alignment overhang treatment (alib.h:20-26)."""

    GLOBAL_LOCAL = 0  # overhangs penalized in template not query
    GLOBAL = 1        # overhangs penalized
    LOCAL_GLOBAL = 2  # overhangs penalized in query not template
    LOCAL = 3         # local alignment
    SEMI_LOCAL = 4    # overhangs not penalized


class OutputFormat(enum.IntEnum):
    """application.h:20-24."""

    HMAP = 0
    PIR = 1
    FASTA = 2


@dataclass
class AliParams:
    """alib.{h,cpp}: core alignment parameters."""

    align_type: AlignT = AlignT.SEMI_LOCAL
    gap_init_penalty: float = 4.73
    gap_extn_penalty: float = 0.34
    submatrix_fn: str = ""

    def read(self, p: ParamStore) -> None:
        if p.find("ALIGN_MODE"):
            self.align_type = AlignT(p.get_int("ALIGN_MODE", int(self.align_type)))
        if p.find("GAP_INIT_PENALTY"):
            self.gap_init_penalty = p.get_float("GAP_INIT_PENALTY")
        if p.find("GAP_EXTN_PENALTY"):
            self.gap_extn_penalty = p.get_float("GAP_EXTN_PENALTY")
        if p.find("SUB_MATRIX"):
            self.submatrix_fn = p.get_str("SUB_MATRIX")


@dataclass
class NOaliParams:
    """noalib.{h,cpp}: near-optimal enumeration parameters."""

    number_suboptimal: int = 200
    subopt_per_round: int = 200
    delta_ratio: float = 0.01
    k_limit: int = 16
    sort_limit: int = 100
    user_limit: int = 100000
    max_overlap: float = 0.30
    final_overlap: float = 0.30
    rounds: int = 4

    def read(self, p: ParamStore) -> None:
        if p.find("NUM_SUBOPT"):
            self.number_suboptimal = p.get_int("NUM_SUBOPT")
        if p.find("NUM_ROUND_SUBOPT"):
            self.subopt_per_round = p.get_int("NUM_ROUND_SUBOPT")
        if p.find("DELTA_RATIO"):
            self.delta_ratio = p.get_float("DELTA_RATIO")
        if p.find("K_LIMIT"):
            self.k_limit = p.get_int("K_LIMIT")
        if p.find("USER_LIMIT"):
            self.user_limit = p.get_int("USER_LIMIT")
        if p.find("SORT_LIMIT"):
            self.sort_limit = p.get_int("SORT_LIMIT")
        if p.find("MAX_OVERLAP"):
            self.max_overlap = p.get_float("MAX_OVERLAP")
        if p.find("FINAL_OVERLAP"):
            self.final_overlap = p.get_float("FINAL_OVERLAP")
        if p.find("ROUNDS"):
            self.rounds = p.get_int("ROUNDS")


@dataclass
class ApplicationParams:
    """application.{h,cpp}: output/verbosity parameters."""

    output_format: OutputFormat = OutputFormat.FASTA
    line_length: int = 60
    verbosity: int = 0
    log_file: str = ""

    def read(self, p: ParamStore) -> None:
        if p.find("OUTPUT_FORMAT"):
            self.output_format = OutputFormat(p.get_int("OUTPUT_FORMAT"))
        if p.find("OUTPUT_LINE_LENGTH"):
            self.line_length = p.get_int("OUTPUT_LINE_LENGTH")
        if p.find("VERBOSE"):
            self.verbosity = p.get_int("VERBOSE")
        if p.find("LOG_FILE"):
            self.log_file = p.get_str("LOG_FILE")


@dataclass
class HMAPaliParams(AliParams, NOaliParams):
    """hmap_eval.{h,cpp}: HMAP profile-profile evaluator parameters.

    Inherits both AliParams and NOaliParams like the C++ class.
    """

    alpha: float = 0.5
    beta: float = 1.0
    gamma: float = 0.1
    normalize_mtx: bool = True
    zero_shift: float = 0.12

    def read(self, p: ParamStore) -> None:  # type: ignore[override]
        if p.find("CORE_MATCH_WEIGHT"):
            self.alpha = p.get_float("CORE_MATCH_WEIGHT")
        if p.find("CORE_GAP_WEIGHT"):
            self.beta = p.get_float("CORE_GAP_WEIGHT")
        if p.find("MOTIF_MATCH_WEIGHT"):
            self.gamma = p.get_float("MOTIF_MATCH_WEIGHT")
        if p.find("NORMALIZE_SIM_MTX"):
            self.normalize_mtx = p.get_bool("NORMALIZE_SIM_MTX")
        if p.find("ZERO_SHIFT"):
            self.zero_shift = p.get_float("ZERO_SHIFT")
        NOaliParams.read(self, p)
        AliParams.read(self, p)


def apply_layers(params_objs, rc: ParamStore | None, top: ParamStore | None,
                 args: ParamStore | None) -> None:
    """Apply the canonical 4-layer precedence to a list of param objects."""
    for layer in (rc, top, args):
        if layer is None:
            continue
        for obj in params_objs:
            obj.read(layer)
