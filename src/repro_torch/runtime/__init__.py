"""Serving runtime of the port: the pipelined decoder (stages in sequence
on one card, sealed boundaries) and the fault-tolerance control plane."""
from .ft import HeartbeatMonitor, OnlineReplanner
from .pipeline import PipelinedDecoder, pipeline_applicable
