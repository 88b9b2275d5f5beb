"""Version of the mash-tpu framework.

Tracks capability parity with Mash 2.3 (reference ``src/mash/version.h:7``);
the leading component is this framework's own version line.
"""

__version__ = "0.1.0"

# Version of the reference tool whose behaviour (CLI, file formats, golden
# outputs) this framework reproduces.
COMPAT_VERSION = "2.3"
