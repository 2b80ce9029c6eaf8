"""Optimizer of the port: AdamW (``adamw``) and the compressed cross-pod
gradient exchange with error feedback (``compression``), which runs
between ranks, one a pod (``launch.ranks``)."""
from .adamw import AdamWConfig, AdamWState, init, update, schedule, global_norm
from .compression import compressed_psum_pod, init_error_feedback
