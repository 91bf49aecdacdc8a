"""The policy-value net and its weight converters."""

from .convert import load_reference_pt, state_dict_from_jax  # noqa: F401
from .resnet import (  # noqa: F401
    XiangqiNet,
    count_parameters,
    init_net,
    policy_logits_fn,
    policy_value_fn,
)
