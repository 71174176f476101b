from repro_torch.models.config import MLACfg, MoECfg, ModelCfg, SSMCfg, param_count  # noqa: F401
from repro_torch.models.lm import (decode_step, forward, init_cache,  # noqa: F401
                                   init_params, loss_fn, prefill)
from repro_torch.models.convert import (opt_state_from_reference,  # noqa: F401
                                        params_from_reference)
