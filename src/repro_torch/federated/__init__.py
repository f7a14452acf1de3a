"""The federated round: aggregation, client store, wire, protocol and the simulator."""
