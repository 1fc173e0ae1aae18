"""Small host helpers: counterpart of `alphatriangle_tpu/utils/helpers.py`'s
`format_eta` (the rest of that module places JAX arrays on devices)."""

import math


def format_eta(seconds: "float | None") -> str:
    """Seconds as 'HH:MM:SS', or 'Xd HH:MM:SS' past a day; 'N/A' for
    None, a negative or a non-finite value."""
    if seconds is None or not math.isfinite(seconds) or seconds < 0:
        return "N/A"
    seconds = int(seconds)
    days, rem = divmod(seconds, 86400)
    hours, rem = divmod(rem, 3600)
    minutes, secs = divmod(rem, 60)
    if days > 0:
        return f"{days}d {hours:02d}:{minutes:02d}:{secs:02d}"
    return f"{hours:02d}:{minutes:02d}:{secs:02d}"
