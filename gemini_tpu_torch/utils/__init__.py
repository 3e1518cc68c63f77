from .trace import start_timer, end_timer, MemoryWatcher
