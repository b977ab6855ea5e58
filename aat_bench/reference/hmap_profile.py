"""Plain HMAP profile-profile scores (the ``--profiles 1`` screen's
semantics), in NumPy and plain PyTorch.

For a query profile and each template profile (both with a sentinel row
at each end): the similarity S[i, j] = dot(aa_q[i], aa_t[j]) * exp(alpha
* pearson(sse_q[i], sse_t[j]) * conf_q[i] * conf_t[j]), its interior
z-normalized and shifted by -zero_shift, borders zero; template gap
values gi, ge = (gap_init, gap_extn) * exp(beta * (1 - 1.25 * p_coil));
a template gap from k to j costs min(gi[k], gi[j]) + min(ge[k], ge[j]) *
(j - k - 2), a query gap of length d at column j costs min(gi[j - 1],
gi[j]) + min(ge[j - 1], ge[j]) * (d - 2).  The score is the best path of
the general-gap DP in the semi-local mode (ALIGN_MODE 4): gaps at either
end of either sequence are free.  Sums follow the HMAP code's order
(sequential float32), so the scores agree with it to rounding.

The DP is swept one query row at a time, vectorized over a group of
templates of similar length: every candidate of a row comes from earlier
rows (a template gap from the row above, a query gap down the column to
the left).
"""

from __future__ import annotations

import numpy as np
import torch

F32 = np.float32
TOKENS = 36      # per residue: index, letter, 20 profile, '-', 6, '*', 6


def read_profile(path: str) -> dict:
    """A ``.prof`` file's rows with a zero sentinel row at each end: aa
    (n + 2, 20), sse (n + 2, 3), conf (n + 2,), gap (n + 2, 2) (the
    sentinels' gap values copied from their neighbours)."""
    with open(path) as f:
        lines = f.read().splitlines()
    n = int(lines[4].split(":", 1)[1].split()[0])
    toks = " ".join(lines[5:]).split()
    if toks[-1] != "//" or len(toks) != n * TOKENS + 1:
        raise ValueError(f"{path}: not a profile of {n} rows")
    rows = np.array(toks[:-1], dtype=object).reshape(n, TOKENS)

    def num(cols):
        return rows[:, cols].astype(np.float64).astype(F32)

    def padded(x):
        out = np.zeros((n + 2,) + x.shape[1:], F32)
        out[1:-1] = x
        return out

    gap = padded(num([23, 24]))
    gap[0], gap[-1] = gap[1], gap[-2]
    return {"aa": padded(num(list(range(2, 22))) / F32(100.0)),
            "sse": padded(num([30, 31, 32])), "conf": padded(num([33])[:, 0]),
            "gap": gap}


def _seq_sum(cols):
    acc = cols[0].copy()
    for c in cols[1:]:
        acc += c
    return acc


def _zrows(sse: np.ndarray) -> np.ndarray:
    """Each row of an (n, 3) array z-normalized (NaN where it is
    constant, as at the sentinels)."""
    k = F32(sse.shape[1])
    cols = [sse[:, c] for c in range(sse.shape[1])]
    avg = _seq_sum(cols) / k
    var = _seq_sum([c * c for c in cols]) / k - avg * avg
    std = np.sqrt(var).astype(F32)
    with np.errstate(divide="ignore", invalid="ignore"):
        return ((sse - avg[:, None]) / std[:, None]).astype(F32)


def _expf(x: np.ndarray) -> np.ndarray:
    return np.exp(x.astype(np.float64)).astype(F32)


def template_gaps(t: dict, params: dict) -> tuple[np.ndarray, np.ndarray]:
    arg = (F32(params["CORE_GAP_WEIGHT"])
           * (F32(1.0) - F32(1.25) * t["sse"][:, 2])).astype(F32)
    pi = _expf(arg)
    return (F32(params["GAP_INIT_PENALTY"]) * pi).astype(F32), \
        (F32(params["GAP_EXTN_PENALTY"]) * pi).astype(F32)


def _stack(ts: list, key: str, t2: int) -> np.ndarray:
    x = ts[0][key]
    out = np.zeros((len(ts), t2) + x.shape[1:], x.dtype)
    for r, t in enumerate(ts):
        out[r, :len(t[key])] = t[key]
    return out


def _similarity(q: dict, ts: list, t2: int, params: dict, dev, dtype):
    """(n, q2, t2) S, its interior z-normalized per pair and shifted."""
    aq = torch.from_numpy(q["aa"]).to(dev, dtype)
    at = torch.from_numpy(_stack(ts, "aa", t2)).to(dev, dtype)
    ip = aq[None, :, None, 0] * at[:, None, :, 0]
    for c in range(1, aq.shape[1]):
        ip = ip + aq[None, :, None, c] * at[:, None, :, c]
    zq = torch.from_numpy(_zrows(q["sse"])).to(dev, dtype)
    zt = torch.from_numpy(np.stack([np.pad(_zrows(t["sse"]),
                                           ((0, t2 - len(t["sse"])), (0, 0)))
                                    for t in ts])).to(dev, dtype)
    pc = zq[None, :, None, 0] * zt[:, None, :, 0]
    for c in range(1, 3):
        pc = pc + zq[None, :, None, c] * zt[:, None, :, c]
    pc = pc / 3.0
    cq = torch.from_numpy(q["conf"]).to(dev, dtype)
    ct = torch.from_numpy(_stack(ts, "conf", t2)).to(dev, dtype)
    arg = float(F32(params["CORE_MATCH_WEIGHT"])) * pc
    arg = arg * cq[None, :, None]
    arg = arg * ct[:, None, :]
    S = ip * torch.exp(arg.double()).to(dtype)
    S = torch.nan_to_num(S, nan=0.0, posinf=0.0, neginf=0.0)
    q2 = S.shape[1]
    host = S.float().cpu().numpy()
    avg = np.zeros(len(ts), F32)
    std = np.ones(len(ts), F32)
    for r, t in enumerate(ts):
        v = host[r, 1:q2 - 1, 1:len(t["aa"]) - 1].ravel()
        n = F32(v.size)
        avg[r] = F32(np.cumsum(v, dtype=F32)[-1] / n)
        var = F32(np.cumsum(v * v, dtype=F32)[-1] / n - avg[r] * avg[r])
        std[r] = F32(np.sqrt(var))
    inner = torch.zeros_like(S, dtype=torch.bool)
    for r, t in enumerate(ts):
        inner[r, 1:q2 - 1, 1:len(t["aa"]) - 1] = True
    if params["NORMALIZE_SIM_MTX"]:
        S = ((S - torch.from_numpy(avg).to(dev, dtype)[:, None, None])
             / torch.from_numpy(std).to(dev, dtype)[:, None, None])
    S = S + float(F32(-params["ZERO_SHIFT"]))
    return torch.where(inner, S, torch.zeros((), dtype=dtype, device=dev))


def _scores(q: dict, ts: list, params: dict, dev, dtype) -> np.ndarray:
    """Semi-local general-gap DP scores of one group of templates."""
    if params["ALIGN_MODE"] != 4:
        raise ValueError("the reference computes ALIGN_MODE 4 (semi-local)")
    q2 = len(q["aa"])
    t2s = np.array([len(t["aa"]) for t in ts])
    t2 = int(t2s.max())
    S = _similarity(q, ts, t2, params, dev, dtype)
    gaps = [template_gaps(t, params) for t in ts]
    gi = torch.from_numpy(np.stack([np.pad(g[0], (0, t2 - len(g[0])))
                                    for g in gaps])).to(dev, dtype)
    ge = torch.from_numpy(np.stack([np.pad(g[1], (0, t2 - len(g[1])))
                                    for g in gaps])).to(dev, dtype)
    k = torch.arange(t2, device=dev)[:, None]
    j = torch.arange(t2, device=dev)[None, :]
    dist = (j - k).to(dtype)
    D = (torch.minimum(gi[:, :, None], gi[:, None, :])
         + torch.minimum(ge[:, :, None], ge[:, None, :]) * (dist - 2.0))
    # a template gap into column j comes from columns 1 .. j - 2
    inf = torch.tensor(float("inf"), dtype=dtype, device=dev)
    D = torch.where((k >= 1) & (j - k >= 2), D, inf)
    A = torch.minimum(gi, torch.roll(gi, 1, dims=1))
    B = torch.minimum(ge, torch.roll(ge, 1, dims=1))
    n = len(ts)
    ninf = torch.tensor(float("-inf"), dtype=dtype, device=dev)
    H = torch.full((n, q2, t2), float("-inf"), dtype=dtype, device=dev)
    # the first row: from the origin, the head gap free; the first column
    # likewise
    H[:, 1, 1:] = S[:, 1, 1:]
    H[:, 1:, 1] = S[:, 1:, 1]
    for i in range(2, q2 - 1):
        prev = H[:, i - 1]
        match = torch.cat([torch.full_like(prev[:, :1], float("-inf")),
                           prev[:, :-1]], dim=1)
        dele = (prev[:, :, None] - D).amax(dim=1)
        best = torch.maximum(match, dele)
        if i >= 3:
            left = torch.cat([torch.full_like(H[:, 1:i - 1, :1], float("-inf")),
                              H[:, 1:i - 1, :-1]], dim=2)
            d2 = torch.arange(i - 3, -1, -1, device=dev).to(dtype)
            cost = A[:, None, :] + B[:, None, :] * d2[None, :, None]
            best = torch.maximum(best, (left - cost).amax(dim=1))
        H[:, i, 2:] = (best + S[:, i])[:, 2:]
    # the closing cell: every gap into it is free and S there is 0
    q1 = q2 - 1
    cols = torch.arange(t2, device=dev)[None, :]
    last_row = torch.where((cols >= 1) & (cols < torch.from_numpy(t2s - 1).to(
        dev)[:, None]), H[:, q1 - 1], ninf).amax(dim=1)
    col = torch.from_numpy(t2s - 2).to(dev)[:, None, None].expand(
        n, q1 - 1, 1)
    last_col = torch.gather(H[:, 1:q1], 2, col)[..., 0].amax(dim=1)
    return torch.maximum(last_row, last_col).double().cpu().numpy()


def scores(query_path: str, template_paths: list, params: dict, device,
           dtype=torch.float32, ratio: float = 1.25) -> np.ndarray:
    """Every template's score (float64 numpy, (N,))."""
    q = read_profile(query_path)
    ts = [read_profile(p) for p in template_paths]
    lens = np.array([len(t["aa"]) for t in ts])
    order = np.argsort(lens, kind="stable")
    out = np.zeros(len(ts))
    start = 0
    with torch.no_grad():
        for i in range(1, len(order) + 1):
            if i == len(order) or lens[order[i]] > ratio * lens[order[start]]:
                idx = order[start:i]
                out[idx] = _scores(q, [ts[r] for r in idx], params, device,
                                   dtype)
                start = i
    return out
