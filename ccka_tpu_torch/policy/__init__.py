"""Decision backends: the interface, the feasibility projection, the
Peak/Off-Peak rule and its carbon-aware variant."""

from ccka_tpu_torch.policy.base import Observation, PolicyBackend  # noqa: F401
from ccka_tpu_torch.policy.carbon import (CarbonAwarePolicy,  # noqa: F401
                                          carbon_zone_weight)
from ccka_tpu_torch.policy.constraints import project_feasible  # noqa: F401
from ccka_tpu_torch.policy.rule import (RulePolicy, offpeak_action,  # noqa: F401
                                        peak_action)
