"""Plain local affine Smith-Waterman (Gotoh): every template's best score
and the top hits' alignments, in plain PyTorch.

A gap of k residues costs ``gi + (k - 1) * ge``.  The matrices are swept
one template column at a time, vectorized over the query and a group of
templates of similar length.  Within a column the vertical gap state is a
prefix maximum: F[i] = max over k < i of H'[k] - gi - (i - 1 - k) * ge,
where H' is the cell's best without F.  That equals the recurrence on the
full H whenever gi >= ge (a gap opened from a cell reached by a gap never
beats extending that gap), and is exact in float32 for integer scores and
gaps, as BLOSUM62 with 12/1 gives.

The alignment of a hit follows the tie rules of the HMAP screen's
traceback: the walk starts at the first query row that holds the best
score and, in it, the first template column; in the H state a cell is
the end of the walk at 0, a match where H equals the diagonal, else a
horizontal gap where H equals E, else a vertical one; a gap state is left
where opening won over extending (extending only where strictly better).
"""

from __future__ import annotations

import numpy as np
import torch


def read_fasta(path: str) -> list[tuple[str, str]]:
    """[(name, residues)] of a multi-FASTA file."""
    out, name, chunks = [], None, []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line.startswith(">"):
                if name is not None:
                    out.append((name, "".join(chunks)))
                name, chunks = line[1:].strip(), []
            elif line:
                chunks.append(line)
    if name is not None:
        out.append((name, "".join(chunks)))
    return out


def read_matrix(path: str) -> tuple[str, np.ndarray]:
    """(alphabet, scores) of an NCBI-format substitution matrix file."""
    with open(path) as f:
        lines = [l for l in f.read().splitlines()
                 if l.strip() and not l.startswith("#")]
    alphabet = "".join(lines[0].split())
    rows = [l.split() for l in lines[1:1 + len(alphabet)]]
    table = np.array([[float(x) for x in r[1:]] for r in rows], np.float32)
    return alphabet, table


def encode(seq: str, alphabet: str) -> np.ndarray:
    lut = np.full(256, -1, np.int64)
    lut[np.frombuffer(alphabet.encode(), np.uint8)] = np.arange(len(alphabet))
    codes = lut[np.frombuffer(seq.upper().encode(), np.uint8)]
    if (codes < 0).any():
        raise ValueError("residue outside the matrix's alphabet")
    return codes


def _groups(lens: np.ndarray, ratio: float = 2.0):
    """Template indices in groups of similar length (ascending), so that
    padding a group to its longest wastes little and the sweeps stay few."""
    order = np.argsort(lens, kind="stable")
    groups, start = [], 0
    for i in range(1, len(order) + 1):
        if i == len(order) or lens[order[i]] > ratio * lens[order[start]]:
            groups.append(order[start:i])
            start = i
    return groups


def _padded(codes: list, idx, pad: int, device) -> tuple:
    tmax = max(len(codes[i]) for i in idx)
    out = np.full((tmax, len(idx)), pad, np.int64)
    for r, i in enumerate(idx):
        out[:len(codes[i]), r] = codes[i]
    lens = torch.tensor([len(codes[i]) for i in idx], device=device)
    return torch.from_numpy(out).to(device), lens


def _sweep(q: np.ndarray, t: torch.Tensor, tlens: torch.Tensor,
           table: np.ndarray, gi: float, ge: float, dtype, keep: bool):
    """Column sweep of one padded group of templates (T, B) against the
    query (Q,).  Returns the best scores (B,) and, with ``keep``, the
    traceback codes (T, B, Q) int8 (bits 0-1: 0 end, 1 match, 2 horizontal
    gap, 3 vertical; bit 2: E extended, bit 3: F extended), each row's best
    (B, Q) and the first column that reached it (B, Q)."""
    dev = t.device
    nq = len(q)
    nt, b = t.shape
    # (A + 1, Q): each template code's scores down the query; the pad code
    # (A) scores -inf, and pad columns are masked out of the best score
    prof = torch.full((table.shape[0] + 1, nq), float("-inf"), dtype=dtype,
                      device=dev)
    prof[:-1] = torch.from_numpy(table[:, q]).to(dev, dtype)
    k_ge = torch.arange(nq, device=dev, dtype=dtype) * ge
    # F[i] = G[i - 1] - (gi + (i - 1) ge), G the prefix max of H' + k ge
    f_off = gi + torch.arange(nq - 1, device=dev, dtype=dtype) * ge
    zero = torch.zeros((), dtype=dtype, device=dev)
    # H and F with a leading column: H's stays 0 (the row above the
    # query), F's -inf
    hbuf = torch.zeros((b, nq + 1), dtype=dtype, device=dev)
    fbuf = torch.full((b, nq), float("-inf"), dtype=dtype, device=dev)
    h, f = hbuf[:, 1:], fbuf
    e = torch.full((b, nq), float("-inf"), dtype=dtype, device=dev)
    colmax = torch.empty((nt, b), dtype=dtype, device=dev)
    if keep:
        codes = torch.empty((nt, b, nq), dtype=torch.int8, device=dev)
        row_best = torch.zeros((b, nq), dtype=dtype, device=dev)
        row_col = torch.zeros((b, nq), dtype=torch.int64, device=dev)
    for j in range(nt):
        diag = hbuf[:, :-1] + prof[t[j]]                    # (B, Q)
        e_ext = e - ge
        e_open = h - gi
        if keep:
            e_bit = (e_ext > e_open).to(torch.int8) << 2
        e = torch.maximum(e_ext, e_open)
        hp = torch.maximum(torch.maximum(diag, e), zero)
        g = torch.cummax(hp + k_ge, dim=1).values
        torch.sub(g[:, :-1], f_off, out=fbuf[:, 1:])
        torch.maximum(hp, f, out=h)
        torch.amax(h, dim=1, out=colmax[j])
        if keep:
            kind = torch.where(h == 0, 0, torch.where(
                h == diag, 1, torch.where(h == e, 2, 3))).to(torch.int8)
            f_bit = ((fbuf[:, :-1] - ge) > (hbuf[:, 1:-1] - gi)).to(
                torch.int8) << 3
            codes[j] = kind | e_bit
            codes[j, :, 1:] |= f_bit
            valid = (j < tlens)[:, None]
            up = valid & (h > row_best)
            row_best = torch.where(up, h, row_best)
            row_col = torch.where(up, j, row_col)
    cols = torch.arange(nt, device=dev)[:, None] < tlens[None, :]
    best = torch.where(cols, colmax, zero).amax(dim=0)
    return best, ((codes, row_best, row_col) if keep else None)


def best_scores(q: np.ndarray, templates: list, table: np.ndarray, gi: float,
                ge: float, device, dtype=torch.float32) -> np.ndarray:
    """Every template's best local score (float64 numpy, (N,))."""
    lens = np.array([len(c) for c in templates])
    out = np.zeros(len(templates))
    with torch.no_grad():
        for idx in _groups(lens):
            t, tl = _padded(templates, idx, table.shape[0], device)
            best, _ = _sweep(q, t, tl, table, gi, ge, dtype, keep=False)
            out[idx] = best.double().cpu().numpy()
    return out


def top_hits(scores: np.ndarray, k: int) -> np.ndarray:
    """Indices of the k best scores: score descending, index ascending."""
    return np.lexsort((np.arange(len(scores)), -scores))[:k]


def alignments(q: np.ndarray, hits: list, table: np.ndarray, gi: float,
               ge: float, device) -> list:
    """Each hit's optimal local alignment as [(query index, template
    index)] matched pairs from the N- to the C-terminus (empty at a best
    score of 0)."""
    with torch.no_grad():
        t, tl = _padded(hits, range(len(hits)), table.shape[0], device)
        _, (code, row_best, row_col) = _sweep(q, t, tl, table, gi, ge,
                                              torch.float32, keep=True)
        code = code.cpu().numpy()
        row_best = row_best.cpu().numpy()
        row_col = row_col.cpu().numpy()
    paths = []
    for lane in range(len(hits)):
        best = row_best[lane].max()
        if best <= 0:
            paths.append([])
            continue
        i = int(np.argmax(row_best[lane] == best))
        j = int(row_col[lane, i])
        path, state = [], 0
        while i >= 0 and j >= 0:
            c = int(code[j, lane, i])
            if state == 0:
                kind = c & 3
                if kind == 0:
                    break
                if kind == 1:
                    path.append((i, j))
                    i, j = i - 1, j - 1
                    continue
                state = 1 if kind == 2 else 2
            if state == 1:
                j -= 1
                state = 1 if c & 4 else 0
            else:
                i -= 1
                state = 2 if c & 8 else 0
        paths.append(path[::-1])
    return paths
