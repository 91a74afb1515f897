from repro_torch.optim.adamw import (Optimizer, adamw, int8_moment_dequant,
                                     int8_moment_quant)
from repro_torch.optim.schedule import cosine_schedule
