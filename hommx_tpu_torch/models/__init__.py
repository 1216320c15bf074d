"""HMM, periodic-homogenization and single-scale FEM solver classes."""

from hommx_tpu_torch.models.fem import LinearElasticityFEM, PoissonFEM
from hommx_tpu_torch.models.hmm import (
    BaseHMM,
    LinearElasticityHMM,
    LinearElasticityStratifiedHMM,
    PoissonHMM,
    PoissonStratifiedHMM,
)
from hommx_tpu_torch.models.periodic import (
    BasePeriodicHMM,
    ElasticityPeriodicHMM,
    PoissonPeriodicHMM,
)

__all__ = [
    "PoissonFEM",
    "LinearElasticityFEM",
    "BaseHMM",
    "PoissonHMM",
    "PoissonStratifiedHMM",
    "LinearElasticityHMM",
    "LinearElasticityStratifiedHMM",
    "BasePeriodicHMM",
    "PoissonPeriodicHMM",
    "ElasticityPeriodicHMM",
]
