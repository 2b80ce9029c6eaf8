"""Control plane of the port: the cost model, the privacy helpers and the
layered placement planner (host code, copies of ``repro/core``)."""
from .cost_model import (CPU, DCN_LINK, GPU, TEE, TPU_POD, TPU_POD_TRUSTED,
                         WAN_30MBPS, DeviceProfile, LinkProfile)
from .privacy import (LM_SIM_DELTA, RESOLUTION_DELTA, cut_exposure,
                      private_depth, resolution_private,
                      resolution_similarity)
