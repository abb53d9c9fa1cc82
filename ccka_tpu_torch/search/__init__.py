"""Adversarial scenario search over an ``[S]`` axis of scenario
parameters: the PyTorch form of `ccka_tpu/search/`.

- `params`: :class:`~ccka_tpu_torch.search.params.ScenarioParams`, the
  batch of natural-unit knobs, its validated search box and the host
  values (`derived()`) the lane generators of the axis consume.
- `axis`: :class:`~ccka_tpu_torch.search.axis.ScenarioAxisSource`, the
  signal source that folds S parameterizations into the batch axis, so
  one kernel launch scores S x B cells.
- `adversarial`: the CEM worst-case search and scenario minting.

Importing `ccka_tpu_torch.search.params` needs numpy and the standard
library only.
"""

from ccka_tpu_torch.search.params import (  # noqa: F401
    PARAM_NAMES,
    SEARCH_BOUNDS,
    SEARCH_SPEC,
    ScenarioParams,
    params_digest,
    validate_bounds,
)
