"""Architecture registry: ``get_config(name)`` / ``get_smoke(name)``.

Every assigned architecture is selectable by id (``--arch <id>``); smoke()
variants are the same family at CPU-test scale.
"""

from repro_torch.configs.base import (InputShape, ModelConfig, SHAPES,
                                      shapes_for, TRAIN_4K, PREFILL_32K,
                                      DECODE_32K, LONG_500K)

from repro_torch.configs import (arctic_480b, deepseek_v3_671b, gemma3_12b,
                                 gemma3_27b, granite_3_2b,
                                 llama_3_2_vision_90b, minitron_8b,
                                 rwkv6_1_6b, whisper_medium, zamba2_7b)

_MODULES = {
    "granite-3-2b": granite_3_2b,
    "minitron-8b": minitron_8b,
    "gemma3-12b": gemma3_12b,
    "gemma3-27b": gemma3_27b,
    "zamba2-7b": zamba2_7b,
    "rwkv6-1.6b": rwkv6_1_6b,
    "whisper-medium": whisper_medium,
    "deepseek-v3-671b": deepseek_v3_671b,
    "arctic-480b": arctic_480b,
    "llama-3.2-vision-90b": llama_3_2_vision_90b,
}

ARCH_NAMES = list(_MODULES)


def get_config(name: str) -> ModelConfig:
    return _MODULES[name].FULL


def get_smoke(name: str) -> ModelConfig:
    return _MODULES[name].smoke()


__all__ = ["ARCH_NAMES", "get_config", "get_smoke", "ModelConfig",
           "InputShape", "SHAPES", "shapes_for", "TRAIN_4K", "PREFILL_32K",
           "DECODE_32K", "LONG_500K"]
