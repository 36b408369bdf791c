"""Matrix-free FacilityLocation on the features, no S held:
``FacilityLocationMF.from_features(x, metric=..., use_kernel=None)``, so
the port's backend gate picks the gain sweep.  The represented set is the
ground set."""
from portbench import reference, work

FAMILY = "FacilityLocation"
judge = reference.judge


def build(x, config):
    from repro_torch.core import FacilityLocationMF

    return FacilityLocationMF.from_features(x, metric=config["metric"], use_kernel=None), None


def step_s(config) -> float:
    """One greedy step recomputes every similarity of the n rows against the
    n candidates at width d."""
    return work.flmf_sweep_s(config["n"], config["n"], config["d"])


def control(x, config, budget):
    """S built with TF32 products and swept as built, in fp32."""
    return reference.control(x, config["metric"], budget, held=False)
