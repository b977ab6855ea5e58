"""HMAP profile sequences (hmapalib_seq.{h,cpp}).

Parses the ``.prof`` format (``ID:/DE:/SR:/EVD:/LEN:`` header, token-stream
per-residue records terminated by ``//``) into structure-of-arrays form, and
provides the LogisticNormal significance model.
"""

from __future__ import annotations

import io
import math

import numpy as np

from .sequence import HEAD, TAIL, Sequence, kyte_hydropathy_table


def _seq_dot(a, b):
    """Sequential float32 dot (reference += accumulation order)."""
    return np.cumsum(a.astype(np.float32) * b.astype(np.float32),
                     dtype=np.float32)[-1]


class HMAPSequence(Sequence):
    """Profile sequence. All per-position arrays have shape (N+2, ...) with
    sentinel rows at 0 and N+1 (zeros except where noted below).

    Arrays:
      aa_profile    (N+2, 20) float32  — profile probabilities (input / 100)
      gap_values    (N+2, 4)  float32  — [gap_init, gap_extn, x, y]; sentinel
                                          rows copied from the adjacent real
                                          residue (hmapalib_seq.cpp:234-235)
      motif_value/motif_confid   (N+2,) float32
      sse_values    (N+2, 3)  float32  — p_helix, p_strand, p_coil
      sse_confid    (N+2,)    float32
      surfacc_value/surfacc_confid (N+2,) float32
      hydropathy    (N+2,)    float32  — profile . fixed table
      lods_type     (N+2,)    int32    — sse-class*3 + confidence tercile
    """

    def __init__(self) -> None:
        super().__init__("", "")
        self.de_field = ""
        self.sr_field = ""
        self.evd1_field = 0.0
        self.evd2_field = 0.0
        n2 = 2
        self.aa_profile = np.zeros((n2, 20), dtype=np.float32)
        self.gap_values = np.zeros((n2, 4), dtype=np.float32)
        self.motif_value = np.zeros(n2, dtype=np.float32)
        self.motif_confid = np.zeros(n2, dtype=np.float32)
        self.sse_values = np.zeros((n2, 3), dtype=np.float32)
        self.sse_confid = np.zeros(n2, dtype=np.float32)
        self.surfacc_value = np.zeros(n2, dtype=np.float32)
        self.surfacc_confid = np.zeros(n2, dtype=np.float32)
        self.hydropathy = np.zeros(n2, dtype=np.float32)
        self.lods_type = np.zeros(n2, dtype=np.int32)
        self._sse_string: str | None = None

    # convenience accessors matching HMAPElem methods
    def p_helix(self, i: int) -> float:
        return float(self.sse_values[i, 0])

    def p_strand(self, i: int) -> float:
        return float(self.sse_values[i, 1])

    def p_coil(self, i: int) -> float:
        return float(self.sse_values[i, 2])

    def gap_init(self, i: int) -> float:
        return float(self.gap_values[i, 0])

    def gap_extn(self, i: int) -> float:
        return float(self.gap_values[i, 1])

    @classmethod
    def from_file(cls, fn: str) -> "HMAPSequence":
        with open(fn) as f:
            return cls.from_stream(f)

    @classmethod
    def from_stream(cls, stream) -> "HMAPSequence":
        self = cls()
        self._read_hmap(stream)
        return self

    # ------------------------------------------------------------------
    def _read_hmap(self, stream) -> None:
        """Parse the .prof format (hmapalib_seq.cpp:182-243)."""
        line = stream.readline()
        if not line:
            raise ValueError("Error reading file")
        # optional "PDB: id chain" first line (consumed by SMAP loader upstream)
        if line.startswith("PDB:"):
            line = stream.readline()
        if not line.startswith("ID"):
            raise ValueError("Parse error before 'ID'")
        self.seq_name = line.split(":", 1)[1].split()[0] if ":" in line else ""

        line = stream.readline()
        if not line.startswith("DE"):
            raise ValueError("Parse error before 'DE'")
        parts = line.split(":", 1)[1].split()
        self.de_field = parts[0] if parts else ""

        line = stream.readline()
        if not line.startswith("SR"):
            raise ValueError("Parse error before 'SR'")
        parts = line.split(":", 1)[1].split()
        self.sr_field = parts[0] if parts else ""

        line = stream.readline()
        if not line.startswith("EVD"):
            raise ValueError("Parse error before 'EVD'")
        vals = line.split(":", 1)[1].split()
        self.evd1_field = float(vals[0])
        self.evd2_field = float(vals[1])

        line = stream.readline()
        if not line.startswith("LEN"):
            raise ValueError("Parse error before 'LEN'")
        n = int(line.split(":", 1)[1].split()[0])

        # token stream over the per-residue records
        toks: list[str] = []
        olcs = []
        n2 = n + 2
        self.aa_profile = np.zeros((n2, 20), dtype=np.float32)
        self.gap_values = np.zeros((n2, 4), dtype=np.float32)
        self.motif_value = np.zeros(n2, dtype=np.float32)
        self.motif_confid = np.zeros(n2, dtype=np.float32)
        self.sse_values = np.zeros((n2, 3), dtype=np.float32)
        self.sse_confid = np.zeros(n2, dtype=np.float32)
        self.surfacc_value = np.zeros(n2, dtype=np.float32)
        self.surfacc_confid = np.zeros(n2, dtype=np.float32)
        self.hydropathy = np.zeros(n2, dtype=np.float32)
        self.lods_type = np.zeros(n2, dtype=np.int32)

        def next_tok():
            while not toks:
                l = stream.readline()
                if not l:
                    raise ValueError("unexpected EOF in profile body")
                toks.extend(l.split())
            return toks.pop(0)

        hpath = kyte_hydropathy_table()
        for i in range(1, n + 1):
            next_tok()  # residue index, unused
            olcs.append(next_tok())
            prof = np.array([float(next_tok()) for _ in range(20)], dtype=np.float32)
            prof = prof / np.float32(100.0)
            self.aa_profile[i] = prof
            self.hydropathy[i] = _seq_dot(prof, hpath)
            if next_tok() != "-":
                raise ValueError("Parse error before '-'")
            self.gap_values[i] = [float(next_tok()) for _ in range(4)]
            self.motif_value[i] = float(next_tok())
            self.motif_confid[i] = float(next_tok())
            if next_tok() != "*":
                raise ValueError("Parse error before '*'")
            self.sse_values[i] = [float(next_tok()) for _ in range(3)]
            self.sse_confid[i] = float(next_tok())
            self.surfacc_value[i] = float(next_tok())
            self.surfacc_confid[i] = float(next_tok())

            # lods type assignment (hmapalib_seq.cpp:100-111)
            idxtype = 3
            if self.sse_values[i, 0] > 0.5:
                idxtype = 0
            if self.sse_values[i, 1] > 0.5:
                idxtype = 1
            if self.sse_values[i, 2] > 0.5:
                idxtype = 2
            idxconf = 0
            if self.sse_confid[i] > 0.33:
                idxconf = 1
            if self.sse_confid[i] > 0.66:
                idxconf = 2
            self.lods_type[i] = idxtype * 3 + idxconf

        # trailing '//'
        line = stream.readline()
        while line and line.strip() == "":
            line = stream.readline()
        if not line or not line.strip().startswith("//"):
            raise ValueError("end of profile '//' not found")

        self._seq_string = HEAD + "".join(olcs) + TAIL
        # sentinel gap values copied from the adjacent residues
        self.gap_values[0] = self.gap_values[1]
        self.gap_values[n + 1] = self.gap_values[n]

    # ------------------------------------------------------------------
    def get_sse_string(self) -> str:
        """Display SSE string (hmapalib_seq.cpp buildSSEString)."""
        if self._sse_string is not None:
            return self._sse_string
        out = []
        for i in range(self.size()):
            ch = self._seq_string[i]
            helix, strand, coil = self.sse_values[i]
            confid = self.sse_confid[i]
            if ch == HEAD:
                s = HEAD
            elif ch == TAIL:
                s = TAIL
            elif helix > strand and helix > coil:
                s = "h" if (helix < 0.5 or confid < 0.5) else "H"
            elif strand > helix and strand > coil:
                s = "e" if (strand < 0.5 or confid < 0.5) else "E"
            else:
                s = " "
            out.append(s)
        self._sse_string = "".join(out)
        return self._sse_string

    def get_default_flags(self, flags) -> None:
        """Mark p_coil>0.3 positions as non-branching (hmapalib_seq.cpp:272-282)."""
        n = self.seq_length
        flags.set(0, True)
        for i in range(1, n + 1):
            flags.set(i, not (self.sse_values[i, 2] > 0.3))
        flags.set(n + 1, True)


class LogisticNormal:
    """Significance model (hmapalib_seq.cpp:284-334): z-score vs each
    profile's EVD (peak,width); normal-erfc p-value below the peak, logistic
    above; two-sided values combined by geometric mean."""

    def __init__(self, q_peak: float, q_width: float, t_peak: float,
                 t_width: float, eff_num: float = 5000.0) -> None:
        self.q_peak = q_peak
        self.q_width = q_width
        self.t_peak = t_peak
        self.t_width = t_width
        self.eff_num = eff_num

    def significance(self, score: float) -> float:
        ev1 = self._one_sided(score, self.t_peak, self.t_width)
        ev2 = self._one_sided(score, self.q_peak, self.q_width)
        if ev1 >= 0 and ev2 >= 0:
            return float(math.sqrt(ev1 * ev2))
        if ev1 >= 0:
            return ev1
        if ev2 >= 0:
            return ev2
        return 9999.0

    def _one_sided(self, score: float, peak: float, width: float) -> float:
        if width <= 0:
            return -1.0
        z = (score - peak) / width
        if z < 0:
            pvalue = math.erfc(z / 1.41421356) / 2.0
        else:
            pvalue = 1.0 / (math.exp(z * 1.81379936) + 1.0)
        return float(np.float32(self.eff_num) * np.float32(pvalue))


def write_prof(seq: HMAPSequence, stream) -> None:
    """Serialize back to .prof (operator<< in hmapalib_seq.cpp)."""
    n = seq.seq_length
    stream.write(f"ID : {seq.seq_name}\n")
    stream.write(f"DE : {seq.de_field}\n")
    stream.write(f"SR : {seq.sr_field}\n")
    stream.write(f"EVD: {seq.evd1_field:g} {seq.evd2_field:g}\n")
    stream.write(f"LEN: {n}\n")
    for i in range(1, n + 1):
        prof = " ".join(f"{v * 100.0:.6f}" for v in seq.aa_profile[i])
        stream.write(f"{i:4d} {seq.olc(i)} {prof}\n")
        gaps = " ".join(f"{v:g}" for v in seq.gap_values[i])
        stream.write(f"   -   {gaps} {seq.motif_value[i]:g} {seq.motif_confid[i]:g}\n")
        sse = " ".join(f"{v:g}" for v in seq.sse_values[i])
        stream.write(
            f"   *   {sse} {seq.sse_confid[i]:g} "
            f"{seq.surfacc_value[i]:g} {seq.surfacc_confid[i]:g}\n"
        )
    stream.write("//\n")
