from .optimal import Optimal, OptimalRev, OptimalSubali
from .cw import ConstrainedNearOptimal
from .ucw import UnconstrainedNearOptimal
from .kscw import KSConstrainedNearOptimal
from .crcw import CRConstrainedNearOptimal

__all__ = [
    "Optimal", "OptimalRev", "OptimalSubali",
    "ConstrainedNearOptimal", "UnconstrainedNearOptimal",
    "KSConstrainedNearOptimal", "CRConstrainedNearOptimal",
]
