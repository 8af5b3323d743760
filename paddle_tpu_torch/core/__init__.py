"""Core IR and runtime: Program, Scope, places, the op registry and the
Executor."""
