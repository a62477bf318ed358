from .checkpoint import latest_step, restore, save
