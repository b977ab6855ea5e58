"""Search rate in GCUPS, as CUDASW++ and SWIPE report it: for the screens
completed in the window, the sum of query length x the library's real
(unpadded) residues, over the window's wall, / 1e9."""


def read(run):
    cells = sum(s.work.get("cells", 0) for s in run.screens)
    return cells / run.window_s / 1e9 if cells else None
