from . import store
from .store import AsyncCheckpointer, latest_step, restore, save
