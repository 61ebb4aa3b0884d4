"""repro_torch.data — the synthetic token pipeline of the LM workload
(counterpart of `repro.data`)."""
from .synthetic import (TokenDataConfig, agent_domain_bias, lm_batch_spec,
                        make_token_batch, token_batches)

__all__ = ["TokenDataConfig", "agent_domain_bias", "lm_batch_spec",
           "make_token_batch", "token_batches"]
