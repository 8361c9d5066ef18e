from repro_torch.models.transformer import LayerSpec, Model, build_layout

__all__ = ["Model", "build_layout", "LayerSpec"]
