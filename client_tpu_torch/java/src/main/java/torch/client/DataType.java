// v2 protocol datatypes with element byte sizes.
// Parity: ref src/java/.../pojo/DataType.java role; BF16 added for the
// bf16 tensors the server speaks.
package torch.client;

public enum DataType {
  BOOL(1), UINT8(1), UINT16(2), UINT32(4), UINT64(8),
  INT8(1), INT16(2), INT32(4), INT64(8),
  FP16(2), BF16(2), FP32(4), FP64(8), BYTES(-1);

  private final int byteSize;

  DataType(int byteSize) { this.byteSize = byteSize; }

  /** Element size in bytes; -1 for variable-length BYTES. */
  public int byteSize() { return byteSize; }
}
