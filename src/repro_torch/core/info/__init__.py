# The ported information measures: the SetCover / ProbabilisticSetCover MI,
# CG and CMI (sc.py).  The FL, GC and LogDet measures and the combinators
# are still to be ported (ROADMAP queue 1, item 8).
from repro_torch.core.info.sc import psc_cg, psc_cmi, psc_mi, sc_cg, sc_cmi, sc_mi
