"""paddle_tpu_torch.incubate — counterpart of paddle_tpu/incubate/
(parity: python/paddle/fluid/incubate/): the fleet's parameter-server
and collective modes (:mod:`.fleet`)."""
