"""Architecture extraction and schedules (numpy copy)."""
from tdnnf_nas_torch.nas.search import (arch_param_count, beam_search_archs,
                                        child_config_from_arch,
                                        extract_bottlenecks, extract_offsets,
                                        temperature_at)
