from celestia_app_tpu_torch.txsim.run import BlobSequence, SendSequence, run

__all__ = ["BlobSequence", "SendSequence", "run"]
