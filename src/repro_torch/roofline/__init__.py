from .analysis import (analyze_step, collective_bytes,  # noqa: F401
                       roofline_terms)
