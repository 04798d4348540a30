"""klara_tpu — a many-chain MCMC inference framework in JAX.

A from-scratch JAX/XLA re-design with the capabilities of the reference
Julia package Klara.jl (generic MCMC engine): targets built from
log-densities / likelihood+prior / distributions, a sampler zoo
(MH, AM, RAM, AMWG, HMC, NUTS, MALA, SMMALA, slice, ARS), step-size
tuners (vanilla, acceptance-rate, dual-averaging, Roberts-Rosenthal),
Gibbs jobs over model graphs, and a device-resident stats layer — all
vectorised over thousands of chains per device and sharded over device
meshes.
"""

from klara_tpu.core.target import Target, bounded_target, whiten_target
from klara_tpu.jobs.chain import Chain
from klara_tpu.jobs.gibbs import GibbsChains, GibbsJob, Nested
from klara_tpu.jobs.job import MCJob, run
from klara_tpu.jobs.range import MCRange
from klara_tpu.models import (
    Constant,
    Data,
    GenericModel,
    GibbsParameter,
    Hyperparameter,
    Transformation,
    likelihood_model,
)
from klara_tpu.samplers import (
    AM,
    AMWG,
    ARS,
    HMC,
    MALA,
    MH,
    NUTS,
    RAM,
    SMMALA,
    SliceSampler,
)
from klara_tpu.tuners import (
    AcceptanceRateTuner,
    DualAveragingTuner,
    RobertsRosenthalTuner,
    VanillaTuner,
)
from klara_tpu import distributions, io, parallel, stats

__version__ = "0.1.0"

__all__ = [
    "Target",
    "bounded_target",
    "whiten_target",
    "Chain",
    "MCJob",
    "MCRange",
    "run",
    "GibbsJob",
    "GibbsChains",
    "Nested",
    "GenericModel",
    "GibbsParameter",
    "Constant",
    "Hyperparameter",
    "Data",
    "Transformation",
    "likelihood_model",
    "MH",
    "AM",
    "RAM",
    "AMWG",
    "ARS",
    "MALA",
    "SMMALA",
    "HMC",
    "NUTS",
    "SliceSampler",
    "VanillaTuner",
    "AcceptanceRateTuner",
    "DualAveragingTuner",
    "RobertsRosenthalTuner",
    "distributions",
    "stats",
]
