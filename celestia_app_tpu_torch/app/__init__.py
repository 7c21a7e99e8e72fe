"""Application entry points of the port."""

from celestia_app_tpu_torch.app.extend_block import extend_block, is_empty_block  # noqa: F401
