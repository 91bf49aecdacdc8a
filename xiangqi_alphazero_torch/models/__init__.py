"""The policy-value net and its weight converters."""

from .convert import (  # noqa: F401
    jax_from_state_dict,
    load_reference_pt,
    state_dict_from_jax,
)
from .resnet import (  # noqa: F401
    XiangqiNet,
    count_parameters,
    init_net,
    policy_logits_fn,
    policy_value_fn,
)
