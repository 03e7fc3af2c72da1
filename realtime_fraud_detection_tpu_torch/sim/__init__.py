"""Load generator and fraud pattern library of the port (the names the JAX
package's ``sim/__init__.py`` exports)."""

from realtime_fraud_detection_tpu_torch.sim.simulator import (  # noqa: F401
    UserPool,
    MerchantPool,
    TransactionGenerator,
)
from realtime_fraud_detection_tpu_torch.sim.fraud_patterns import (  # noqa: F401
    FraudScenario,
    AdvancedFraudPatterns,
    BASIC_FRAUD_MIX,
)
from realtime_fraud_detection_tpu_torch.sim.arrivals import (  # noqa: F401
    DiurnalBurstConfig,
    DiurnalBurstProcess,
)
