"""CLI launchers (reference L7: execute_server.lua / execute_worker.lua /
remove_results.sh)."""
