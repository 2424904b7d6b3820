from .analysis import (HW_H100, CellReport, analyze_step, collective_bytes,
                       collective_bytes_of, count_step,
                       dispatch_cache_report, roofline_terms)
