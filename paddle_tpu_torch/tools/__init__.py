"""Measurement scripts of the port that run on the card (``python3 -m
paddle_tpu_torch.tools.<name>``); importing them runs nothing."""
