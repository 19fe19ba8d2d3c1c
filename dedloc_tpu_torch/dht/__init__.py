from dedloc_tpu_torch.dht.node import DHTNode
from dedloc_tpu_torch.dht.dht import DHT
from dedloc_tpu_torch.dht.crypto import RSAPrivateKey
from dedloc_tpu_torch.dht.validation import (
    RecordValidatorBase,
    RSASignatureValidator,
    SchemaValidator,
    CompositeValidator,
    DHTRecord,
)
