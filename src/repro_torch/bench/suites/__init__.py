"""The port's benchmark suites; importing this package registers their
scenarios with :mod:`repro_torch.bench`, in this order."""
from repro_torch.bench.suites import allocation  # noqa: F401
from repro_torch.bench.suites import load_balance  # noqa: F401
from repro_torch.bench.suites import efficiency  # noqa: F401
from repro_torch.bench.suites import roofline  # noqa: F401
from repro_torch.bench.suites import serving  # noqa: F401
from repro_torch.bench.suites import batch_precision  # noqa: F401
from repro_torch.bench.suites import kernels  # noqa: F401
from repro_torch.bench.suites import scalability  # noqa: F401
from repro_torch.bench.suites import scaling_matrix  # noqa: F401
from repro_torch.bench.suites import trace  # noqa: F401
from repro_torch.bench.suites import tune  # noqa: F401
