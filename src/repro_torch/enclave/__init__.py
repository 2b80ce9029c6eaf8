"""Trust domains and sealing (port of ``repro.enclave``): the domain
registry the planner places over, the quantizing activation seal at stage
boundaries and the lossless page seal of the host swap tier."""
from .domain import (ResourceManager, TrustDomain, default_two_pod_manager,
                     sandwich_manager, two_enclave_manager)
from . import sealing
