from .adamw import (AdamW, AdamWState, SGD, clip_by_global_norm,
                    clip_scale, cosine_schedule, global_norm,
                    linear_schedule)
