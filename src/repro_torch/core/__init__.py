"""Core layers of the port: containers, tableau, engine, solver loops, front door.

Each module follows the file of the same name in ``repro/core``.
"""
