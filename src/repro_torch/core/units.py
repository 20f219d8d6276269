"""Byte/time unit helpers used across the consolidation core.

All core-model quantities are plain floats in SI-ish units:
  sizes      -> bytes
  times      -> seconds
  throughput -> bytes / second
"""

KB = 1024.0
MB = 1024.0 * KB
GB = 1024.0 * MB

US = 1e-6
MS = 1e-3


def parse_size(text: str) -> float:
    """Parse sizes like '32KB', '64MB', '1GB', '512' (bytes) into bytes.

    Used to ingest the paper's Table III workload tuples verbatim.
    """
    s = text.strip().upper().replace(" ", "")
    for suffix, mult in (("KB", KB), ("MB", MB), ("GB", GB), ("K", KB), ("M", MB), ("G", GB), ("B", 1.0)):
        if s.endswith(suffix):
            return float(s[: -len(suffix)]) * mult
    return float(s)



def fmt_size(n: float) -> str:
    for mult, suffix in ((GB, "GB"), (MB, "MB"), (KB, "KB")):
        if n >= mult:
            v = n / mult
            return f"{v:.0f}{suffix}" if abs(v - round(v)) < 1e-9 else f"{v:.2f}{suffix}"
    return f"{n:.0f}B"
