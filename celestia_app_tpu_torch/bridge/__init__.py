"""The C bridge's square backend on the port: worker.py speaks the CSQ1
protocol of bridge/celestia_square_bridge.cpp, client.py drives the C ABI
over ctypes."""
