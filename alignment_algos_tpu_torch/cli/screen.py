"""``aat_screen`` on PyTorch + CUDA (counterpart of
``alignment_algos_tpu/cli/screen.py``).

FASTA mode: one query FASTA sequence is screened against every sequence of
a library FASTA: K1 scores every template on the device, a deterministic
top-k ranks them, K2 emits the top hits' traceback codes, which are
decoded on the device, and the hits are UPGMA-clustered on the ali_dist
area metric.

``--profiles 1``: a query ``.prof`` against a directory (or list file) of
``.prof`` templates, scored with the exact HMAP evaluator: K5 and K6 build
the similarity on the device, K3 runs the general-gap DP.  ``--smap 1``:
fold recognition over SMAP structure templates with ``Gn2Eval``, costs
built on the host, K3 on the device.  Output is byte-equal to the JAX
package's tool in every mode.  Where more than one card is visible, the
library (FASTA) or each length bucket (profiles) is split over all of them
(``parallel/screen``), as the JAX tool splits it over its mesh.

    python -m alignment_algos_tpu_torch.cli.screen query.fa library.fa
        [--top_k 10] [--gap_init F] [--gap_extn F] [--SUB_MATRIX file]
        [--cluster_threshold 8.0] [--ckpt state.npz] [--chunk_size 1024]
    python -m alignment_algos_tpu_torch.cli.screen query.prof templates/
        --profiles 1 [--top_k 10] [--KEY value ...]
    python -m alignment_algos_tpu_torch.cli.screen query.prof smaps.txt
        --smap 1 [--top_k 10] [--KEY value ...]

``AAT_TORCH_DEVICE`` picks the device (``cuda`` by default, or ``cpu``);
``AAT_TRACE_DIR`` writes a trace of the whole run there.

Under a recording ``torch.profiler`` every call is one ``aat_screen`` span
(``utils.profiling``), its stages spans beneath it: ``fasta.read_inputs``
(``fasta.read``, ``fasta.encode``), ``screen.library`` and ``cluster`` in
FASTA mode, where the root counts the ``cards`` the library is split over
(1 without a mesh); ``profile.read`` and ``hmap.screen`` with
``--profiles 1``.
"""

from __future__ import annotations

import sys
from typing import NamedTuple

import numpy as np
import torch

from ..scoring.submatrix import BlosumMatrix
from ..utils import profiling
from ..utils.params import (AliParams, ApplicationParams, Argv, RCfile,
                            apply_layers)
from ..utils.torchenv import device_from_env, maybe_start_trace

__all__ = ["PAD_WALL", "ScreenInputs", "main", "read_inputs",
           "read_profiles"]

# the JAX package's aat_screen encoding (cli/screen.py:37-76), verbatim but
# for encode_library, which gives the same codes by a byte table
PAD_WALL = -1.0e4


def read_fasta_plain(fn: str) -> list[tuple[str, str]]:
    """[(name, residues)] — plain multi-FASTA, no sentinels."""
    out: list[tuple[str, str]] = []
    name = None
    chunks: list[str] = []
    with open(fn) as f:
        for line in f:
            line = line.strip()
            if line.startswith(">"):
                if name is not None:
                    out.append((name, "".join(chunks)))
                name = line[1:].strip() or f"seq_{len(out)}"
                chunks = []
            elif line:
                chunks.append(line.replace(" ", ""))
    if name is not None:
        out.append((name, "".join(chunks)))
    if not out:
        raise ValueError(f"no sequences in {fn}")
    return out


def _byte_table(index: dict[str, int]) -> np.ndarray:
    """256-entry int32 table: an ASCII byte's code in ``index``, -1 for
    every other byte."""
    table = np.full(256, -1, dtype=np.int32)
    for c, i in index.items():
        if len(c) == 1 and c.isascii():
            table[ord(c)] = i
    return table


def encode_library(seqs: list[str], index: dict[str, int], pad_code: int):
    """Pad-encode to (N, Tmax) int32 with the pad wall code.

    The codes equal the JAX tool's ``[index[c] for c in s.upper()]`` per
    sequence, by one byte-table lookup over the whole upper-cased library.
    A sequence holding a byte outside the alphabet (a non-ASCII character
    among them) goes through that very expression, so it raises the same
    ``KeyError``.  Counts the real ``residues`` onto the innermost open
    span."""
    codes, residues = _encode(seqs, index, pad_code)
    profiling.count("residues", residues)
    return codes


def _encode(seqs: list[str], index: dict[str, int], pad_code: int):
    """:func:`encode_library`'s codes, and the number of real residues."""
    lens = np.fromiter(map(len, seqs), dtype=np.int64, count=len(seqs))
    tmax = int(lens.max())
    codes = np.full((len(seqs), tmax), pad_code, dtype=np.int32)
    # a non-ASCII sequence stands as NUL bytes (code -1) of its length, so
    # the ASCII upper-casing keeps every offset
    buf = "".join(s if s.isascii() else "\0" * len(s)
                  for s in seqs).upper().encode("ascii")
    flat = _byte_table(index)[np.frombuffer(buf, dtype=np.uint8)]
    codes[np.arange(tmax) < lens[:, None]] = flat
    if flat.size and flat.min() < 0:
        for i in np.flatnonzero((codes < 0).any(axis=1)):
            s = seqs[i]
            codes[i, : len(s)] = [index[c] for c in s.upper()]
    return codes, flat.size


def padded_table(bl: BlosumMatrix):
    """Substitution table extended with a pad row/col of PAD_WALL."""
    n = len(bl.alphabet)
    t = np.full((n + 1, n + 1), PAD_WALL, dtype=np.float32)
    t[:n, :n] = bl.matrix
    return t, n  # pad code = n


class ScreenInputs(NamedTuple):
    """The screen's host inputs, pad-wall encoded as the JAX package's
    ``aat_screen`` encodes them."""
    query_name: str
    query_len: int
    names: list
    q_codes: np.ndarray      # (Q,) int32
    t_codes: np.ndarray      # (N, Tmax) int32, padded with pad_code
    table: np.ndarray        # (A, A) float32 with the pad wall
    pad_code: int


def read_inputs(query_fa: str, library_fa: str,
                submatrix_fn: str) -> ScreenInputs:
    """Query FASTA (first record), library FASTA and substitution matrix
    file -> :class:`ScreenInputs`.  Spans: ``fasta.read_inputs``, and
    beneath it ``fasta.read`` (the files) and ``fasta.encode`` (the
    library's codes, with :func:`encode_library`'s counters)."""
    with profiling.span("fasta.read_inputs"):
        with profiling.span("fasta.read"):
            query_name, query_seq = read_fasta_plain(query_fa)[0]
            library = read_fasta_plain(library_fa)
            bl = BlosumMatrix(submatrix_fn)
        table, pad_code = padded_table(bl)
        index = {c: i for i, c in enumerate(bl.alphabet)}
        q_codes = _encode([query_seq], index, pad_code)[0][0]
        with profiling.span("fasta.encode"):
            t_codes = encode_library([s for _, s in library], index,
                                     pad_code)
        return ScreenInputs(query_name, len(query_seq),
                            [n for n, _ in library], q_codes, t_codes, table,
                            pad_code)


def main(argv=None) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    try:
        device = device_from_env()
    except RuntimeError as e:
        print(e, file=sys.stderr)
        return -1
    maybe_start_trace()
    try:
        with profiling.span("aat_screen"):
            return _run(argv, device)
    except (ValueError, OSError) as e:
        print(e, file=sys.stderr)
        return -1


def _run(argv, device: torch.device) -> int:
    args = Argv(argv)
    if args.dohelp or args.count() < 2:
        print("Usage: aat_screen query.fa library.fa [--top_k N "
              "--gap_init F --gap_extn F --SUB_MATRIX file "
              "--cluster_threshold F --ckpt file --chunk_size N]",
              file=sys.stderr)
        return 0

    ali_params = AliParams()
    app_params = ApplicationParams()
    rc = RCfile()
    topfile = ""
    if args.get_switch("-top", erase=False):
        topfile = args.get_switch_arg("-top", 1)
    top = RCfile(topfile) if topfile else None
    apply_layers([ali_params, app_params], rc, top, args)

    k = args.get_int("top_k", 10)
    gi = args.get_float("gap_init", ali_params.gap_init_penalty)
    ge = args.get_float("gap_extn", ali_params.gap_extn_penalty)
    thresh = args.get_float("cluster_threshold", 8.0)
    ckpt = args.get_str("ckpt", "")
    chunk = args.get_int("chunk_size", 1024)
    if args.get_int("profiles", 0) == 1:
        return _run_profiles(args, k, rc, top, device)  # needs no submatrix
    if args.get_int("smap", 0) == 1:
        return _run_profiles(args, k, rc, top, device, smap=True)

    if not ali_params.submatrix_fn:
        raise ValueError("no substitution matrix: pass --SUB_MATRIX <file> "
                         "or set SUB_MATRIX in ~/.hmaprc / -top file")

    inp = read_inputs(args.get_arg(0), args.get_arg(1),
                      ali_params.submatrix_fn)
    q_codes, t_codes, table = inp.q_codes, inp.t_codes, inp.table

    mesh = _mesh(device)
    profiling.count("cards", mesh.size if mesh is not None else 1)
    if ckpt:
        from ..parallel.checkpoint import screen_library_checkpointed
        scores, idx, done = screen_library_checkpointed(
            q_codes, t_codes, table, gi, ge, k=k, chunk_size=chunk,
            ckpt_path=ckpt, mesh=mesh, device=device)
        if not done:
            print("screen incomplete (resume with the same command)",
                  file=sys.stderr)
    else:
        from ..parallel.screen import screen_library
        scores, idx = screen_library(q_codes, t_codes, table, gi, ge, k=k,
                                     mesh=mesh, device=device)

    names = inp.names
    print(f"# query: {inp.query_name} ({inp.query_len} aa) vs "
          f"{len(names)} templates; top {len(idx)}")
    print("# rank\tscore\tindex\tname")
    for r, (s, i) in enumerate(zip(scores, idx), start=1):
        print(f"{r}\t{s:g}\t{int(i)}\t{names[int(i)]}")

    if len(idx) >= 2:
        _cluster_hits(q_codes, t_codes, table, gi, ge, idx, names, thresh,
                      inp.pad_code, device)
    return 0


def _mesh(device: torch.device):
    """A mesh of every visible card where there is more than one, else
    None (one device), as the JAX tool takes its mesh
    (cli/screen.py:204-210)."""
    if device.type != "cuda" or torch.cuda.device_count() < 2:
        return None
    from ..parallel.screen import default_mesh
    return default_mesh(device=device)


def read_profiles(query_fn: str, lib_arg: str, smap: bool = False):
    """The query profile and the template profiles of a directory of
    ``.prof`` files (sorted) or of a list file, one path per line.

    Returns (query ``HMAPSequence``, templates, file names); the templates
    are ``SMAPSequence`` (gn2) when ``smap``, else ``HMAPSequence``.  Span:
    ``profile.read``, counting the parsed profiles' ``rows`` (every
    profile's ``size()``)."""
    import glob
    import os

    from ..seq.hmap import HMAPSequence

    with profiling.span("profile.read"):
        query = HMAPSequence.from_file(query_fn)
        if os.path.isdir(lib_arg):
            files = sorted(glob.glob(os.path.join(lib_arg, "*.prof")))
        else:
            with open(lib_arg) as f:
                files = [line.strip() for line in f if line.strip()]
        if not files:
            raise ValueError(f"no template profiles found in {lib_arg}")
        if smap:
            from ..structure.smap import SMAPSequence
            templates = [SMAPSequence.from_file(fn, gn2=True)
                         for fn in files]
        else:
            templates = [HMAPSequence.from_file(fn) for fn in files]
        if profiling.recording():
            profiling.count("rows", query.size()
                            + sum(t.size() for t in templates))
    return query, templates, files


def _run_profiles(args, k: int, rc, top, device: torch.device,
                  smap: bool = False) -> int:
    """``--profiles 1`` (exact HMAP profile-profile screen) and ``--smap
    1`` (Gn2Eval fold recognition over SMAP templates), each length bucket
    split over the visible cards where there are several."""
    from ..parallel.screen import screen_profiles

    query, templates, files = read_profiles(args.get_arg(0), args.get_arg(1),
                                            smap=smap)
    if smap:
        from ..scoring.gn2_eval import Gn2Eval, Gn2Params
        params = Gn2Params()
        apply_layers([params], rc, top, args)
        factory = lambda q, t: Gn2Eval(params)
        kind = "SMAP structure"
    else:
        from ..scoring.hmap_eval import HMAPaliEval, HMAPaliParams
        params = HMAPaliParams()
        apply_layers([params], rc, top, args)
        factory = lambda q, t: HMAPaliEval(params)
        kind = "template"

    scores, order = screen_profiles(query, templates, factory, k=k,
                                    device=device, mesh=_mesh(device))
    print(f"# query profile vs {len(templates)} {kind} profiles; "
          f"top {len(order)}")
    print("# rank\tscore\tindex\tfile")
    for r, i in enumerate(order, start=1):
        print(f"{r}\t{scores[int(i)]:g}\t{int(i)}\t{files[int(i)]}")
    return 0


def _cluster_hits(q_codes, t_codes, table, gi, ge, idx, names,
                  thresh: float, pad_code: int,
                  device: torch.device) -> None:
    """Cluster the top hits by the reference alignment-distance metric.

    Every hit's optimal local alignment against the query comes from one
    K2 launch, decoded on the device; each alignment is a polyline over the
    shared query axis, and the hit-hit distance is Ali_Dist's exact area
    between two polylines divided by the query length
    (ali_dist.cpp:160-414,633-638).  Spans: ``cluster``, and beneath it
    the hits' ``to_device``, ``k2``, ``k8``, ``cluster.paths``,
    ``cluster.area`` and ``cluster.upgma``."""
    from ..analysis.ali_dist import ResPair, area_matrix
    from ..analysis.upgma import UPGMAClusterer
    from ..ops import swaffine

    with profiling.span("cluster"):
        hits = t_codes[np.asarray(idx, dtype=np.int64)]
        n = len(hits)
        qlen = q_codes.shape[0]
        tlens = (hits != pad_code).sum(axis=1)
        qb = np.broadcast_to(q_codes, (n, qlen))
        _, paths = swaffine.sw_affine_tb_batch(qb, hits, table, gi, ge,
                                               device=device)

        # polylines in Ali_Dist's (t, q) convention with the QUERY as the
        # shared t axis, 1-based and sentinel-anchored at both ends exactly
        # as strings_to_vrp renders the '^'/'$' matches
        with profiling.span("cluster.area"):
            vrps = [
                [ResPair(0, 0)]
                + [ResPair(qi + 1, ti + 1) for qi, ti in p]
                + [ResPair(qlen + 1, int(tlens[b]) + 1)]
                for b, p in enumerate(paths)
            ]
            dist = (np.asarray(area_matrix(vrps), dtype=np.float64)
                    / float(qlen))

        with profiling.span("cluster.upgma"):
            clusterer = UPGMAClusterer(dist)
            clusterer.cluster()
            clusters = clusterer.find_clusters_under_threshold(thresh)
    print(f"# clusters (UPGMA cut at {thresh:g}): {len(clusters)}")
    for ci, members in enumerate(clusters, start=1):
        label = ", ".join(names[int(idx[m])] for m in members)
        print(f"cluster {ci}: {label}")


if __name__ == "__main__":
    sys.exit(main())
