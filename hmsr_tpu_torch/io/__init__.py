from .burst import Burst, load_burst, load_npz_burst, save_npz_burst

__all__ = ["Burst", "load_burst", "load_npz_burst", "save_npz_burst"]
