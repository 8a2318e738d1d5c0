from repro_torch.models.model import (DenseLM, EncDecLM, HybridLM, MoeLM,
                                      RwkvLM, VisionLM, build_model,
                                      decode_step, init_decode_state,
                                      init_params, loss_fn, make_trainable,
                                      padded_vocab, param_count, prefill)

__all__ = ["DenseLM", "EncDecLM", "HybridLM", "MoeLM", "RwkvLM", "VisionLM",
           "build_model", "decode_step", "init_decode_state", "init_params",
           "loss_fn", "make_trainable", "padded_vocab", "param_count", "prefill"]
