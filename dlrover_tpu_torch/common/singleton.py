"""Thread-safe singleton helper — the port's copy of
``dlrover_tpu/common/singleton.py``."""

import threading


class Singleton:
    _instance = None
    _instance_lock = threading.Lock()

    @classmethod
    def singleton_instance(cls, *args, **kwargs):
        if cls._instance is None:
            with cls._instance_lock:
                if cls._instance is None:
                    cls._instance = cls(*args, **kwargs)
        return cls._instance

    @classmethod
    def reset_singleton(cls):
        with cls._instance_lock:
            cls._instance = None
