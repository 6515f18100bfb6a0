"""The TF-Serving messages the perf analyzer's ``tfserve`` backend speaks,
built from ``tfs.proto`` (a subset of TF-Serving's public protos, with
their field numbers) in a private descriptor pool.

The port's own copy of ``client_tpu/perf/foreign/tfs_pb2.py``: the same
message classes (``pb.PredictRequest``, ``pb.GetModelMetadataResponse``
and so on) and ``DataType`` enum values. The descriptor goes into a
``DescriptorPool`` of this module's own, never the process's default
pool, so this module and the reference's (which declares the same
``tensorflow.serving.*`` symbols) load into one process; their messages
are wire compatible.

``_DESCRIPTOR`` is the serialized ``FileDescriptorProto`` of
``tfs.proto``. After an edit of the .proto, regenerate it from this
directory with::

    protoc --descriptor_set_out=tfs.desc tfs.proto
    python -c "from google.protobuf import descriptor_pb2 as d; \\
        print(d.FileDescriptorSet.FromString( \\
        open('tfs.desc', 'rb').read()).file[0].SerializeToString())"

and paste the bytes below (then delete ``tfs.desc``).
"""

from google.protobuf import descriptor_pb2, descriptor_pool, message_factory
from google.protobuf.internal import enum_type_wrapper

_DESCRIPTOR = (
    b'\n\ttfs.proto\x12\x12tensorflow.serving"\x82\x01\n\x10TensorShapeProto\x125\n\x03'
    b'dim\x18\x02 \x03(\x0b2(.tensorflow.serving.TensorShapeProto.Dim\x12\x14\n\x0cu'
    b'nknown_rank\x18\x03 \x01(\x08\x1a!\n\x03Dim\x12\x0c\n\x04size\x18\x01 \x01(\x03\x12\x0c\n\x04name\x18\x02 \x01(\t"\xb9\x02\n'
    b'\x0bTensorProto\x12+\n\x05dtype\x18\x01 \x01(\x0e2\x1c.tensorflow.serving.DataTyp'
    b'e\x12:\n\x0ctensor_shape\x18\x02 \x01(\x0b2$.tensorflow.serving.TensorShape'
    b'Proto\x12\x16\n\x0etensor_content\x18\x04 \x01(\x0c\x12\x12\n\nstring_val\x18\x08 \x03(\x0c\x12\x11\n\tflo'
    b'at_val\x18\x05 \x03(\x02\x12\x12\n\ndouble_val\x18\x06 \x03(\x01\x12\x0f\n\x07int_val\x18\x07 \x03(\x05\x12\x11\n\tint'
    b'64_val\x18\n \x03(\x03\x12\x10\n\x08bool_val\x18\x0b \x03(\x08\x12\x10\n\x08half_val\x18\r \x03(\x05\x12\x12\n\nuint'
    b'32_val\x18\x10 \x03(\r\x12\x12\n\nuint64_val\x18\x11 \x03(\x04"\x83\x01\n\tModelSpec\x12\x0c\n\x04name\x18\x01'
    b' \x01(\t\x126\n\x07version\x18\x02 \x01(\x0b2%.tensorflow.serving.ModelSpec.Ver'
    b'sion\x12\x16\n\x0esignature_name\x18\x03 \x01(\t\x1a\x18\n\x07Version\x12\r\n\x05value\x18\x01 \x01(\x03"\xea'
    b'\x01\n\x0ePredictRequest\x121\n\nmodel_spec\x18\x01 \x01(\x0b2\x1d.tensorflow.servi'
    b'ng.ModelSpec\x12>\n\x06inputs\x18\x02 \x03(\x0b2..tensorflow.serving.Predic'
    b'tRequest.InputsEntry\x12\x15\n\routput_filter\x18\x03 \x03(\t\x1aN\n\x0bInputsEnt'
    b'ry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12.\n\x05value\x18\x02 \x01(\x0b2\x1f.tensorflow.serving.Tens'
    b'orProto:\x028\x01"\xd8\x01\n\x0fPredictResponse\x12A\n\x07outputs\x18\x01 \x03(\x0b20.tenso'
    b'rflow.serving.PredictResponse.OutputsEntry\x121\n\nmodel_spec'
    b'\x18\x02 \x01(\x0b2\x1d.tensorflow.serving.ModelSpec\x1aO\n\x0cOutputsEntry\x12\x0b\n'
    b'\x03key\x18\x01 \x01(\t\x12.\n\x05value\x18\x02 \x01(\x0b2\x1f.tensorflow.serving.TensorPro'
    b'to:\x028\x01"\x83\x01\n\nTensorInfo\x12\x0c\n\x04name\x18\x01 \x01(\t\x12+\n\x05dtype\x18\x02 \x01(\x0e2\x1c.ten'
    b'sorflow.serving.DataType\x12:\n\x0ctensor_shape\x18\x03 \x01(\x0b2$.tensorf'
    b'low.serving.TensorShapeProto"\xc0\x02\n\x0cSignatureDef\x12<\n\x06inputs\x18'
    b'\x01 \x03(\x0b2,.tensorflow.serving.SignatureDef.InputsEntry\x12>\n\x07o'
    b'utputs\x18\x02 \x03(\x0b2-.tensorflow.serving.SignatureDef.OutputsEn'
    b'try\x12\x13\n\x0bmethod_name\x18\x03 \x01(\t\x1aM\n\x0bInputsEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12-\n\x05'
    b'value\x18\x02 \x01(\x0b2\x1e.tensorflow.serving.TensorInfo:\x028\x01\x1aN\n\x0cOutpu'
    b'tsEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12-\n\x05value\x18\x02 \x01(\x0b2\x1e.tensorflow.serving'
    b'.TensorInfo:\x028\x01"\xb6\x01\n\x0fSignatureDefMap\x12L\n\rsignature_def\x18\x01 \x03'
    b'(\x0b25.tensorflow.serving.SignatureDefMap.SignatureDefEntr'
    b'y\x1aU\n\x11SignatureDefEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12/\n\x05value\x18\x02 \x01(\x0b2 .ten'
    b'sorflow.serving.SignatureDef:\x028\x01"+\n\x08AnyProto\x12\x10\n\x08type_url'
    b'\x18\x01 \x01(\t\x12\r\n\x05value\x18\x02 \x01(\x0c"d\n\x17GetModelMetadataRequest\x121\n\nmode'
    b'l_spec\x18\x01 \x01(\x0b2\x1d.tensorflow.serving.ModelSpec\x12\x16\n\x0emetadata_'
    b'field\x18\x02 \x03(\t"\xea\x01\n\x18GetModelMetadataResponse\x121\n\nmodel_spec\x18\x01'
    b' \x01(\x0b2\x1d.tensorflow.serving.ModelSpec\x12L\n\x08metadata\x18\x02 \x03(\x0b2:.'
    b'tensorflow.serving.GetModelMetadataResponse.MetadataEntr'
    b'y\x1aM\n\rMetadataEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12+\n\x05value\x18\x02 \x01(\x0b2\x1c.tensorf'
    b'low.serving.AnyProto:\x028\x01*\xd4\x01\n\x08DataType\x12\x0e\n\nDT_INVALID\x10\x00\x12\x0c\n'
    b'\x08DT_FLOAT\x10\x01\x12\r\n\tDT_DOUBLE\x10\x02\x12\x0c\n\x08DT_INT32\x10\x03\x12\x0c\n\x08DT_UINT8\x10\x04\x12\x0c'
    b'\n\x08DT_INT16\x10\x05\x12\x0b\n\x07DT_INT8\x10\x06\x12\r\n\tDT_STRING\x10\x07\x12\x0c\n\x08DT_INT64\x10\t\x12\x0b'
    b'\n\x07DT_BOOL\x10\n\x12\r\n\tDT_UINT32\x10\x16\x12\r\n\tDT_UINT64\x10\x17\x12\x0f\n\x0bDT_BFLOAT16'
    b'\x10\x0e\x12\x0b\n\x07DT_HALF\x10\x13b\x06proto3'
)

_POOL = descriptor_pool.DescriptorPool()
_POOL.Add(descriptor_pb2.FileDescriptorProto.FromString(_DESCRIPTOR))
DESCRIPTOR = _POOL.FindFileByName("tfs.proto")

for _name, _desc in DESCRIPTOR.message_types_by_name.items():
    globals()[_name] = message_factory.GetMessageClass(_desc)
DataType = enum_type_wrapper.EnumTypeWrapper(
    DESCRIPTOR.enum_types_by_name["DataType"])
for _value in DataType.DESCRIPTOR.values:
    globals()[_value.name] = _value.number
del _name, _desc, _value
