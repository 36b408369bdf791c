# The ported information measures: the generic MI / CG / CMI combinators
# (combinators.py) and the closed forms for Facility Location (fl.py), Graph
# Cut (gc.py), Log Determinant (logdet.py), Concave-Over-Modular (com.py)
# and SetCover / ProbabilisticSetCover (sc.py).
from repro_torch.core.info.com import ConcaveOverModular
from repro_torch.core.info.combinators import (
    ConditionedFunction,
    DifferenceFunction,
    generic_cg,
    generic_cmi,
    generic_mi,
)
from repro_torch.core.info.fl import FLCG, FLCMI, FLQMI, FLVMI
from repro_torch.core.info.gc import GCMI, gccg, gccmi
from repro_torch.core.info.logdet import logdet_cg, logdet_cmi, logdet_mi
from repro_torch.core.info.sc import psc_cg, psc_cmi, psc_mi, sc_cg, sc_cmi, sc_mi
