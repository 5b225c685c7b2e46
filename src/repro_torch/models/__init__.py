from repro_torch.models.transformer import Model, build_model

__all__ = ["Model", "build_model"]
