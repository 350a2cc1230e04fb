from repro_torch.configs.registry import ARCHS, get_arch

__all__ = ["ARCHS", "get_arch"]
