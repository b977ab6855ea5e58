"""The share of K1's launched cells that are padding: 100 x (1 - the
needed cells / the launched ones), summed over the window's screens.
Launched: the ``cells`` the program counts in its span ``k1``
(``ops/swaffine.sw_affine_scores``, Q x T x B) under ``screen.library``.
Needed: the span's ``q`` times the real ``residues`` that the span
``fasta.encode`` of the same screen counts."""

from aat_bench import program_spans


def read(run):
    got = program_spans.screens(run)
    if got is None:
        return None
    needed = launched = 0
    for screen in got:
        k1 = program_spans.named(screen, "k1", "screen.library")
        enc = program_spans.named(screen, "fasta.encode")
        if not k1 or len(enc) != 1:
            continue
        needed += k1[0].counts["q"] * enc[0].counts["residues"]
        launched += sum(r.counts["cells"] for r in k1)
    return 100.0 * (1.0 - needed / launched) if launched else None
