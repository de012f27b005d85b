"""The benchmark's reference: LiquidFun's water step in plain PyTorch
(water) and the scenes worked out from their configurations
(<scene>.py, found by the scene's name). Imports nothing of
box2d_tpu_torch, box2d_tpu or jax."""
