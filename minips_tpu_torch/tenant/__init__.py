"""Multi-tenant tables — many models, one PS fleet, isolated SLOs.

See ``minips_tpu_torch.tenant.registry`` for the ``MINIPS_TENANT`` grammar
and the namespace/isolation contract.
"""

from minips_tpu_torch.tenant.registry import (TenantRegistry, TenantSpec,
                                        maybe_registry)

__all__ = ["TenantRegistry", "TenantSpec", "maybe_registry"]
