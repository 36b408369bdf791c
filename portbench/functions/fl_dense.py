"""FacilityLocation on a dense S built once by the port's similarity kernel
(``create_kernel``) and kept resident: ``FacilityLocation.from_kernel(S,
use_kernel=None)``, so the port's backend gate picks the gain sweep."""
from portbench import reference, work

FAMILY = "FacilityLocation"
judge = reference.judge


def build(x, config):
    from repro_torch.core import FacilityLocation, create_kernel

    S = create_kernel(x, metric=config["metric"], use_pallas=True)
    return FacilityLocation.from_kernel(S, use_kernel=None), S


def step_s(config) -> float:
    """One greedy step reads the (n, n) fp32 S once."""
    return work.fl_sweep_s(config["n"], config["n"])


def control(x, config, budget):
    """S built with TF32 products and swept as held in bfloat16."""
    return reference.control(x, config["metric"], budget, held=True)
