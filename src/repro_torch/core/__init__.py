"""The batching runtime: graphs, batching policies, memory planning,
cell compilation, and the interpreted and compiled executors."""
