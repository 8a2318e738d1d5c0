from repro_torch.models.model import (DenseLM, decode_step, init_decode_state,
                                      init_params, loss_fn, padded_vocab,
                                      param_count, prefill)

__all__ = ["DenseLM", "decode_step", "init_decode_state", "init_params",
           "loss_fn", "padded_vocab", "param_count", "prefill"]
