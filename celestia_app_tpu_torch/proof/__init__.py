"""Share inclusion proofs to the data root (the port's copy of
celestia_app_tpu/proof/share_proof.py)."""
