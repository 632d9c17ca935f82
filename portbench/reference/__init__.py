"""The plain reference: seeded leaf values, a plain snapshot reader and
writer, and the comparisons that decide a run's ``correct``.

Plain PyTorch and the standard library only: nothing here imports the
program under test, and nothing reads a value the program derived.
"""
