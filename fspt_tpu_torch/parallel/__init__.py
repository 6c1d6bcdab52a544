"""Training across devices (port of fspt_tpu.parallel): the differentiable
train step of parallel/dist.py, on one device so far."""
